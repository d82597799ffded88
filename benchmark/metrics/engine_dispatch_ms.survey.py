"""engine_dispatch_ms.survey: the median host time of one call that
enqueues a batch (``Engine.dispatch``), from the harness's
``bench:dispatch`` stamps."""

import numpy as np


def read(ctx):
    spans = [end - start for start, end, _ in ctx.win.dispatches]
    return float(np.median(spans)) * 1e3 if spans else None
