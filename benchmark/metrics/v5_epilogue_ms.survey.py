"""v5_epilogue_ms.survey: device time per detector call of the operations
launched inside ``det:network`` and, within it, inside a ``det:v5:epilogue``
range (``models/yolov5.py``: a conv's BatchNorm and SiLU, a Bottleneck's
residual add) or a ``qdq`` range (``quant/int8.py``: a conv input's
quantize-dequantize): the elementwise passes between the v5 convs. Nothing
is read from a program without a ``det:v5:epilogue`` range."""

EPILOGUE = {"det:v5:epilogue", "qdq"}


def read(ctx):
    s = ctx.summary
    calls = len(ctx.win.dispatches)
    if s is None or not calls or not s.range_spans("det:v5:epilogue"):
        return None
    lo, hi = s.window
    total = 0
    for e in s.device:
        names = s.launched_in.get(e.corr, ())
        if "det:network" not in names or not EPILOGUE.intersection(names):
            continue
        start, end = max(e.start, lo), min(e.end, hi)
        if end > start:
            total += end - start
    return total / 1e9 / calls * 1e3 if total > 0 else None
