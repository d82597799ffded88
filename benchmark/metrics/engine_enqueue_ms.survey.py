"""engine_enqueue_ms.survey: the host time of the program's
``engine:forward`` spans (``export/engine.py``: normalize, network,
softmax and cast, enqueued on the card) in the traced window, over the
window's dispatches."""


def read(ctx):
    s = ctx.summary
    calls = len(ctx.win.dispatches)
    if s is None or not calls:
        return None
    spans = s.range_spans("engine:forward")
    if not spans:
        return None
    return sum(r.end - r.start for r in spans) / calls / 1e6
