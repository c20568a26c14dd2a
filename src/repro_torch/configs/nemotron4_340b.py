"""nemotron-4-340b [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, squared-ReLU MLP.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, act="sq_relu",
    source="arXiv:2402.16819 (Nemotron-4 340B)",
)

SMOKE = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=384, vocab=509, act="sq_relu",
    source="reduced smoke variant",
)

register(FULL, SMOKE)
