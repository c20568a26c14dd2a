"""rwkv6-3b (Finch) [arXiv:2404.05892].

32L d_model=2560, attention-free (data-dependent decay linear recurrence),
channel-mix d_ff=8960, vocab=65536, head size 64 (40 heads).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

FULL = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_head=64, d_ff=8960, vocab=65536, act="relu_sq_channelmix",
    rope_mode="none", rwkv_head_dim=64,
    ssm=SSMConfig(d_state=64, head_dim=64),
    source="arXiv:2404.05892 (RWKV-6 Finch)",
)

SMOKE = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=499, act="relu_sq_channelmix",
    rope_mode="none", rwkv_head_dim=16,
    ssm=SSMConfig(d_state=16, head_dim=16),
    source="reduced smoke variant",
)

register(FULL, SMOKE)
