"""det_network_ms.survey: device time per detector call of the operations
launched inside the program's ``det:normalize`` and ``det:network``
ranges (``export/detector.py``)."""


def read(ctx):
    s = ctx.summary
    calls = len(ctx.win.dispatches)
    if s is None or not calls:
        return None
    spent = s.device_s(ranges=("det:normalize", "det:network"))
    return spent / calls * 1e3 if spent > 0 else None
