"""acff_roofline_pct.survey: the least time of the ACFF blocks' work at the
engine's batch (``roofline.acff_bound_sum``, bytes over HBM bandwidth
against operations over the bf16 peak, per block) over the device time per
batch of the kernels whose name holds ``acff``."""

from benchmark import roofline


def read(ctx):
    s = ctx.summary
    batches = len(ctx.win.dispatches)
    if s is None or not batches or not hasattr(ctx.ref_mod, "block_shapes"):
        return None
    spent = s.device_s(lambda e: e.kind == "kernel" and "acff" in e.name)
    if spent <= 0:
        return None
    batch = ctx.win.dispatches[0][2]
    bound = roofline.acff_bound_sum(
        batch, ctx.ref_mod.block_shapes(ctx.config, ctx.ref_state))
    return 100.0 * bound / (spent / batches)
