"""host_wait_ms.survey: the host time of the program's ``*:wait`` spans
(each a point where a call blocks the host on the card) in the traced
window, over the window's dispatches. A program range is one named
``engine:*``, ``det:*`` or ``qdq``; with none in the window, nothing is
read."""


def _program(name):
    return name.startswith(("engine:", "det:")) or name == "qdq"


def read(ctx):
    s = ctx.summary
    calls = len(ctx.win.dispatches)
    if s is None or not calls:
        return None
    lo, hi = s.window
    spans = [r for r in s.ranges if _program(r.name)
             and r.start >= lo and r.end <= hi]
    if not spans:
        return None
    waits = [r for r in spans if r.name.endswith(":wait")]
    return sum(r.end - r.start for r in waits) / calls / 1e6
