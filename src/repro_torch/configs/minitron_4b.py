"""minitron-4b [arXiv:2407.14679] -- pruned Nemotron-4.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000, squared-ReLU MLP.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab=256000, act="sq_relu",
    source="arXiv:2407.14679 (Minitron)",
)

SMOKE = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab=491, act="sq_relu",
    source="reduced smoke variant",
)

register(FULL, SMOKE)
