"""Serving layer: micro-batching dispatch over the fixed-batch engines.

Counterpart of ``rtdm_tpu/serve``: ``MicroBatcher`` coalesces concurrent
single-frame requests into an engine's fixed batch; ``cli/serve.py`` is
the stdlib-HTTP front end.
"""

from rtdm_tpu_torch.serve.batcher import (BatcherStats,  # noqa: F401
                                          MicroBatcher)
