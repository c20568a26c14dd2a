"""Architecture and shape configuration.

The counterpart of ``repro.configs.base``: the same dataclasses, parameter
counts and registry, so a configuration name means the same model in both
packages.  Each architecture's module registers its published
:class:`ArchConfig` and a reduced ``smoke`` variant for the CPU tests.

Every architecture of the reference is registered: the dense, MoE, VLM,
audio, SSM (RWKV-6) and hybrid (Mamba-2 with shared attention) families.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    num_shared: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    conv_width: int = 4
    expand: int = 2               # inner dim = expand * d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # defaults to d_model // n_heads
    act: str = "swiglu"                   # swiglu | geglu | sq_relu | gelu
    qk_norm: bool = False
    rope_mode: str = "full"               # full | half (chatglm 2d) | none
    rope_base: float = 10000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0                   # hybrid: shared attn block period
    embed_input: bool = False             # vlm/audio stub: frontend embeddings
    prefix_len: int = 0                   # vlm: bidirectional prefix length
    tie_embeddings: bool = False
    rwkv_head_dim: int = 64               # ssm family = rwkv6
    source: str = ""                      # public provenance note

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM / hybrid only)."""
        return self.family in ("ssm", "hybrid")

    def num_params(self) -> int:
        """Analytic parameter count (embedding + per-layer + head)."""
        d, dh = self.d_model, self.head_dim
        embed = self.vocab * d
        per_layer = 0
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) \
            + (self.n_heads * dh) * d
        if self.act in ("swiglu", "geglu"):
            ffn_dense = 3 * d * self.d_ff
        else:
            ffn_dense = 2 * d * self.d_ff
        if self.family == "ssm":
            d_in = self.ssm.expand * d if self.ssm else 2 * d
            # rwkv6 time-mix + channel-mix rough accounting
            attn = 4 * d * d + d_in
            ffn_dense = 2 * d * self.d_ff
        if self.family == "hybrid":
            # Mamba2 layers have no separate FFN: in_proj + out_proj + conv.
            d_in = self.ssm.expand * d
            attn = d * (2 * d_in + 2 * self.ssm.d_state) + d_in * d
            ffn_dense = 0
        if self.moe is not None:
            if self.act in ("swiglu", "geglu"):
                per_expert = 3 * d * self.moe.d_expert
            else:
                per_expert = 2 * d * self.moe.d_expert
            ffn = (self.moe.num_experts + self.moe.num_shared) * per_expert \
                + d * self.moe.num_experts           # router
        else:
            ffn = ffn_dense
        per_layer = attn + ffn + 2 * d
        total = embed + self.n_layers * per_layer + d
        if not self.tie_embeddings:
            total += self.vocab * d
        if self.family == "hybrid" and self.attn_every:
            shared_attn = 4 * d * d + 3 * d * self.d_ff
            total += shared_attn
        return int(total)

    def num_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.num_params()
        d = self.d_model
        per_expert = (3 if self.act in ("swiglu", "geglu") else 2) \
            * d * self.moe.d_expert
        inactive = (self.moe.num_experts - self.moe.top_k) * per_expert
        return int(self.num_params() - self.n_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, ArchConfig] = {}
_SMOKE_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    _ensure_loaded()
    reg = _SMOKE_REGISTRY if smoke else _REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch '{name}'; have {sorted(reg)}")
    return reg[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def runnable_cells() -> List[Tuple[str, str]]:
    """All (arch, shape) dry-run cells; long_500k only for sub-quadratic
    archs (full-attention archs skip it)."""
    _ensure_loaded()
    cells = []
    for arch in list_archs():
        cfg = _REGISTRY[arch]
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((arch, shape.name))
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    _ensure_loaded()
    out = []
    for arch in list_archs():
        cfg = _REGISTRY[arch]
        if not cfg.sub_quadratic:
            out.append((arch, "long_500k",
                        "full quadratic attention at 524288 tokens"))
    return out


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # Importing the modules triggers register() calls.
    from repro_torch.configs import (chatglm3_6b, minitron_4b,  # noqa: F401
                                     moonshot_v1_16b, musicgen_large,
                                     nemotron4_340b, paligemma_3b,
                                     phi35_moe, qwen3_1p7b, rwkv6_3b,
                                     zamba2_2p7b)
