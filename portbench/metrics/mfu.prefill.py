"""Model FLOPs of the real (unpadded) prompt tokens of the requests the
window completed (the configuration's own ``prefill_flops``) over the
bf16 peak times the window's seconds, in percent."""
from portbench import peaks


def read(ctx):
    work = sum(ctx.model.prefill_flops(ctx.config, n)
               for n in ctx.window["prompt_lengths"])
    return 100.0 * work / (peaks.BF16_FLOPS * ctx.window["seconds"])
