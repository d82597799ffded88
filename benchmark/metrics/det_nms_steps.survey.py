"""det_nms_steps.survey: the mean over calls of the greedy fixpoint's
steps, ``Detector.stats["greedy_steps"]`` (``ops/nms.py``), read after
each call."""


def read(ctx):
    steps = ctx.win.counters.get("greedy_steps")
    return sum(steps) / len(steps) if steps else None
