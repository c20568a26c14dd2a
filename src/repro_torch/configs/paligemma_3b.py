"""paligemma-3b [arXiv:2407.07726].

18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384 vocab=257216.
SigLIP vision frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings; the Gemma-style decoder treats them as a bidirectional prefix
(PaliGemma prefix-LM attention).
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_head=256, d_ff=16384, vocab=257216, act="geglu",
    embed_input=True, prefix_len=256,     # 256 SigLIP patch tokens
    source="arXiv:2407.07726 (PaliGemma); gemma-2b decoder",
)

SMOKE = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_head=16, d_ff=128, vocab=521, act="geglu",
    embed_input=True, prefix_len=8,
    source="reduced smoke variant",
)

register(FULL, SMOKE)
