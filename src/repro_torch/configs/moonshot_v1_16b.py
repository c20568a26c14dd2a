"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=163840,
MoE 64 experts top-6 (kimi/moonlight).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, act="swiglu",
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408),
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=48, vocab=769, act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=3, d_expert=48),
    source="reduced smoke variant",
)

register(FULL, SMOKE)
