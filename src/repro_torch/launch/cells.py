"""Per-(arch x shape) dry-run cell options; the counterpart of
``repro.launch.cells``, with the reference's values.

Training memory levers (microbatching, sequence parallelism, the optimizer
state's dtype) have per-arch defaults; the dry run's ``memory_analysis``
says whether each cell's per-device peak fits the card's memory.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs.base import SHAPES
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_loop import TrainOptions


@dataclasses.dataclass(frozen=True)
class CellOptions:
    train: TrainOptions
    opt: OptimizerConfig
    seq_parallel: bool
    # Decode-cache sequence-shard axes (logical): "model" default; long
    # batch=1 contexts spread over data+model ("seq2").
    cache_seq_axes: Tuple[str, ...] = ("model",)


# seq_parallel is a per-arch decision: the Megatron-SP residual constraint
# trades whole-weight gathers inside the layer loop (bytes ~ d^2 per layer
# per microbatch) against full-sequence activation traffic (bytes ~ T*d per
# layer); the reference turns it off for d = 18432 (nemotron) and on for
# the d <= 4096 archs where the activation traffic dominated.
_TRAIN_DEFAULTS = {
    # arch -> (microbatches, seq_parallel, opt_state_dtype)
    "nemotron-4-340b": (16, False, "bfloat16"),
    "phi3.5-moe-42b-a6.6b": (4, True, "float32"),
    "moonshot-v1-16b-a3b": (4, False, "float32"),
    "chatglm3-6b": (4, True, "float32"),
    "minitron-4b": (4, True, "float32"),
    "qwen3-1.7b": (2, False, "float32"),
    "paligemma-3b": (2, False, "float32"),
    "musicgen-large": (4, False, "float32"),
    "rwkv6-3b": (4, False, "float32"),
    "zamba2-2.7b": (4, False, "float32"),
}


def cell_options(arch: str, shape_name: str,
                 microbatches: Optional[int] = None,
                 seq_parallel: Optional[bool] = None,
                 opt_dtype: Optional[str] = None) -> CellOptions:
    shape = SHAPES[shape_name]
    mb, sp, od = _TRAIN_DEFAULTS.get(arch, (1, False, "float32"))
    if microbatches is not None:
        mb = microbatches
    if seq_parallel is not None:
        sp = seq_parallel
    if opt_dtype is not None:
        od = opt_dtype
    if shape.kind != "train":
        mb, sp = 1, False
    cache_axes: Tuple[str, ...] = ("model",)
    if shape.name == "long_500k":
        # batch=1: spread the KV/cache sequence over data x model.
        cache_axes = ("seq2",)
    return CellOptions(
        train=TrainOptions(microbatches=mb),
        opt=OptimizerConfig(state_dtype=od),
        seq_parallel=sp,
        cache_seq_axes=cache_axes,
    )
