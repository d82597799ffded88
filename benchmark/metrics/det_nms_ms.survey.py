"""det_nms_ms.survey: the mean host time of the program's ``det:nms``
range (``export/detector.py`` around ``ops/nms.py::batched_nms``) per
call, in the traced window."""


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    spans = s.range_spans("det:nms")
    if not spans:
        return None
    return sum(r.end - r.start for r in spans) / len(spans) / 1e6
