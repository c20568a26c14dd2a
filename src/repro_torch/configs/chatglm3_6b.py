"""chatglm3-6b [arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
2-d RoPE: rotary applied to half the head dims (ChatGLM convention).
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, act="swiglu", rope_mode="half",
    source="arXiv:2406.12793 (ChatGLM); hf:THUDM/chatglm3-6b",
)

SMOKE = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=499, act="swiglu", rope_mode="half",
    source="reduced smoke variant",
)

register(FULL, SMOKE)
