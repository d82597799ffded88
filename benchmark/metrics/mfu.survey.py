"""mfu.survey: the operations of the frames completed in the traced window
(the reference's count a frame: convs and dense layers, two a
multiply-add) over the window's seconds, as a share of the chip's bf16
peak (989 TFLOP/s, data sheet, 700 W; the run prints the card's power
limit beside it)."""

from benchmark import roofline


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.win.completed_in_window:
        return None
    rate = ctx.flops_per_frame * ctx.win.completed_in_window / s.window_s
    return 100.0 * rate / roofline.PEAK_OPS_PER_S["bf16"]
