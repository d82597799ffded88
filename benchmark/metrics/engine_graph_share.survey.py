"""engine_graph_share.survey: the share of the program's ``engine:forward``
spans in the traced window that replayed the forward as one CUDA graph
(``export/engine.py``: an ``engine:graph`` span around the replay), as 100
x the ``engine:graph`` spans over the ``engine:forward`` spans. Nothing is
read without an ``engine:forward`` span, nor from a program that has no
``engine:graph`` span."""


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    forwards = s.range_spans("engine:forward")
    graphs = s.range_spans("engine:graph")
    if not forwards or not graphs:
        return None
    return 100.0 * len(graphs) / len(forwards)
