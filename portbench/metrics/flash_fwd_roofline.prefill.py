"""Percent of the roofline of the flash-attention forward calls in the
profiled prefill rounds (each call's shape as the benchmark saw it) over
the device time of ``csrc/flash_attention.cu``'s kernels."""
from portbench import flops

KERNELS = ("flash_attention_kernel", "flash_attention_tc")


def read(ctx):
    return flops.calls_share(ctx.trace, "flash_fwd", flops.flash_fwd,
                             KERNELS)
