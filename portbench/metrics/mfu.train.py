"""Model FLOPs of the window's training steps (the configuration's own
``train_step_flops``, from the published widths) over the bf16 peak
times the window's seconds, in percent."""
from portbench import peaks


def read(ctx):
    mix, win = ctx.mix, ctx.window
    work = win["units"] * ctx.model.train_step_flops(
        ctx.config, mix["batch"], mix["seq_len"])
    return 100.0 * work / (peaks.BF16_FLOPS * win["seconds"])
