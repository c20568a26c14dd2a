"""qwen3-1.7b [hf:Qwen/Qwen3-1.7B family, per assignment hf:Qwen/Qwen3-8B].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, qk-norm.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_head=128, d_ff=6144, vocab=151936, act="swiglu", qk_norm=True,
    source="hf:Qwen/Qwen3-1.7B (qk_norm, GQA)",
)

SMOKE = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, vocab=487, act="swiglu", qk_norm=True,
    source="reduced smoke variant",
)

register(FULL, SMOKE)
