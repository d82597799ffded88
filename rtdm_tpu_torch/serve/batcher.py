"""Micro-batching dispatcher for fixed-batch engines.

Counterpart of ``rtdm_tpu/serve/batcher.py``. Serving shape: one card,
one fixed-batch engine, many concurrent single-frame clients. The batcher
coalesces requests into the engine's batch, keeps up to ``depth`` batches
in flight (batch k+1 is enqueued on the card before batch k is copied
back: the double buffering of ``cli/realtime_inference.py``), and resolves
each request's Future with its row of the copied-back output.

The dispatcher runs on its own thread. ``torch.inference_mode`` is a
per-thread setting, so a ``dispatch`` carries its own (``Engine.dispatch``
and ``Detector.forward`` do).

The reference has no analogue: its stream loops are single-frame and
synchronous (real-time-inference.py:179-208, trt_yolo.py:130-162).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class BatcherStats:
    requests: int = 0
    batches: int = 0
    rows_padded: int = 0          # wasted rows (padding) across batches
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    mean_batch: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _materialize(out: Any) -> Any:
    """A device result (a tensor, or a tuple or list of them) copied to
    the host as numpy arrays; waits for the card."""
    if isinstance(out, (tuple, list)):
        return type(out)(_materialize(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


def _row(out: Any, i: int) -> Any:
    if isinstance(out, (tuple, list)):
        return type(out)(o[i] for o in out)
    return out[i]


class MicroBatcher:
    """Coalesce concurrent requests into fixed-shape engine batches.

    ``dispatch`` takes a uint8 (n<=batch, ...) array and returns a device
    result batched along axis 0 without waiting for it (``Engine.dispatch``,
    or a ``Detector``'s ``submit`` without its n: anything whose output rows
    align with input rows). ``max_wait_ms`` bounds how long the first
    request of a batch waits for company; ``depth`` is the number of
    in-flight batches.
    """

    def __init__(self, dispatch: Callable[[np.ndarray], Any],
                 batch_size: int, max_wait_ms: float = 2.0, depth: int = 2,
                 latency_window: int = 4096):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._dispatch = dispatch
        self._batch = batch_size
        self._max_wait = max_wait_ms / 1e3
        self._depth = depth
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._new_work = threading.Event()
        self._closed = False
        self._lat = collections.deque(maxlen=latency_window)
        self._sizes: collections.deque = collections.deque(
            maxlen=latency_window)
        self._batches = 0
        self._requests = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rtdm-microbatcher")
        self._thread.start()

    # -- client side -----------------------------------------------------
    def submit(self, frame: np.ndarray) -> "Future":
        """Enqueue one frame; the Future resolves to that frame's output
        row(s). Raises after close()."""
        fut: Future = Future()
        # closed-check and enqueue are atomic with the shutdown drain
        # (which runs under the same lock after _closed is set), so a
        # racing submit either raises here or has its future failed by the
        # drain — never a forever-pending future
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append((frame, time.perf_counter(), fut))
        self._new_work.set()
        return fut

    def __call__(self, frame: np.ndarray, timeout: Optional[float] = 30.0):
        return self.submit(frame).result(timeout=timeout)

    # -- stats / lifecycle ------------------------------------------------
    def stats(self) -> BatcherStats:
        lat = sorted(self._lat)
        sizes = list(self._sizes)
        return BatcherStats(
            requests=self._requests,
            batches=self._batches,
            rows_padded=sum(self._batch - s for s in sizes),
            p50_ms=1e3 * lat[len(lat) // 2] if lat else 0.0,
            p99_ms=1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))]
            if lat else 0.0,
            mean_batch=float(np.mean(sizes)) if sizes else 0.0)

    def close(self) -> None:
        self._closed = True
        self._new_work.set()
        self._thread.join(timeout=60)

    # -- dispatcher thread --------------------------------------------------
    def _take_batch(self) -> Sequence[Tuple[np.ndarray, float, Future]]:
        """Wait for the first request, then fill up to batch_size rows or
        until the micro-batch deadline passes."""
        while True:
            with self._lock:
                if self._queue:
                    break
                self._new_work.clear()
            if self._closed:
                return ()
            self._new_work.wait(timeout=0.05)
        deadline = time.perf_counter() + self._max_wait
        while True:
            with self._lock:
                if len(self._queue) >= self._batch:
                    break
            now = time.perf_counter()
            if now >= deadline or self._closed:
                break
            time.sleep(min(self._max_wait / 8, deadline - now))
        with self._lock:
            n = min(len(self._queue), self._batch)
            return [self._queue.popleft() for _ in range(n)]

    def _resolve(self, inflight) -> None:
        out, reqs = inflight
        try:
            host = _materialize(out)
        except Exception as e:  # engine failure propagates to every waiter
            for _, _, fut in reqs:
                fut.set_exception(e)
            return
        # timestamp AFTER materialization: the device compute + D2H wait is
        # part of what clients observe on fut.result(); stamping before it
        # would report only queue+dispatch time as "latency"
        done = time.perf_counter()
        for i, (_, t0, fut) in enumerate(reqs):
            self._lat.append(done - t0)
            fut.set_result(_row(host, i))

    def _run(self) -> None:
        inflight: collections.deque = collections.deque()
        while True:
            with self._lock:
                idle = not self._queue
            if idle and inflight:
                # no waiting work: drain the in-flight batch now rather
                # than letting it sit until the next request shows up
                self._resolve(inflight.popleft())
                continue
            reqs = self._take_batch()
            if not reqs:
                if inflight:
                    self._resolve(inflight.popleft())
                    continue
                if self._closed:
                    break
                continue
            frames = np.stack([r[0] for r in reqs])
            try:
                out = self._dispatch(frames)
            except Exception as e:
                for _, _, fut in reqs:
                    fut.set_exception(e)
                continue
            self._requests += len(reqs)
            self._batches += 1
            self._sizes.append(len(reqs))
            inflight.append((out, reqs))
            if len(inflight) > self._depth - 1:
                self._resolve(inflight.popleft())
        while inflight:
            self._resolve(inflight.popleft())
        # fail any stragglers enqueued during shutdown
        with self._lock:
            leftovers = list(self._queue)
            self._queue.clear()
        for _, _, fut in leftovers:
            fut.set_exception(RuntimeError("MicroBatcher closed"))
