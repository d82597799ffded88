"""launches_per_call.survey: the device operations (kernels, copies, sets)
that start in the traced window and were launched inside a program range
(one named ``engine:*``, ``det:*`` or ``qdq``), counted once a correlation
id, over the window's dispatches; nothing is read without a program range
in the window."""


def _program(name):
    return name.startswith(("engine:", "det:")) or name == "qdq"


def read(ctx):
    s = ctx.summary
    calls = len(ctx.win.dispatches)
    if s is None or not calls:
        return None
    lo, hi = s.window
    if not any(_program(r.name) and r.start >= lo and r.end <= hi
               for r in s.ranges):
        return None
    launched = {e.corr for e in s.device if lo <= e.start < hi
                and any(_program(n) for n in s.launched_in.get(e.corr, ()))}
    return len(launched) / calls
