"""zamba2-2.7b [arXiv:2411.15242].

54L d_model=2560 (Mamba2 backbone, ssm_state=64) + shared attention block
(32H, kv=32) applied every 6 layers with shared weights; shared-block MLP
d_ff=10240, vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

FULL = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_head=80, d_ff=10240, vocab=32000, act="gelu",
    ssm=SSMConfig(d_state=64, head_dim=64, conv_width=4, expand=2),
    attn_every=6,
    source="arXiv:2411.15242 (Zamba2)",
)

SMOKE = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=251, act="gelu",
    ssm=SSMConfig(d_state=16, head_dim=16, conv_width=4, expand=2),
    attn_every=2,
    source="reduced smoke variant",
)

register(FULL, SMOKE)
