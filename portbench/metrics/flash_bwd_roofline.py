"""Percent of the roofline of the flash-attention backward launches in the
profiled training steps over the device time of
``csrc/flash_attention_bwd.cu``'s kernels.  Each backward launch is of the
shape of the forward calls the steps made (one shape in a step of one
sequence length; with several, nothing is read)."""
from portbench import flops, harness, peaks

KERNELS = ("flash_attention_bwd_dq_", "flash_attention_bwd_dkdv_")


def read(ctx):
    launches = ctx.trace["counters"].get("flash_bwd", 0)
    shapes = set(ctx.trace["calls"].get("flash_fwd", []))
    seconds = harness.device_seconds(ctx.trace, KERNELS)
    if not launches or len(shapes) != 1 or seconds is None:
        return None
    f, b = flops.flash_bwd(*shapes.pop())
    return flops.roofline_share(launches * f, launches * b, seconds,
                                peaks.BF16_FLOPS, peaks.HBM_BYTES)
