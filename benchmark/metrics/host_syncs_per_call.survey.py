"""host_syncs_per_call.survey: the program's ``*:wait`` spans (each a
point where a call blocks the host on the card) in the traced window, over
the window's dispatches. A program range is one named ``engine:*``,
``det:*`` or ``qdq``; with none in the window, nothing is read, and a
program that blocks nowhere reads 0."""


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
    return sum(1 for r in spans if r.name.endswith(":wait")) / calls
