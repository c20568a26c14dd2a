"""musicgen-large [arXiv:2306.05284].

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048; decoder-only
over EnCodec tokens.  The EnCodec frontend is a STUB: ``input_specs``
provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, act="gelu", embed_input=True,
    source="arXiv:2306.05284 (MusicGen large)",
)

SMOKE = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, act="gelu", embed_input=True,
    source="reduced smoke variant",
)

register(FULL, SMOKE)
