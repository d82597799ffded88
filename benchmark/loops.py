"""The loop that drives a system through a window.

It stamps the harness's own spans: ``bench:window`` around the window,
``bench:dispatch`` around each call that enqueues a batch and
``bench:resolve`` around each copy back. They are ``record_function``
ranges, which a traced run's profiler keeps, and host-clock stamps that the
metrics read.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
from torch.profiler import record_function


@dataclasses.dataclass
class Window:
    start: float = 0.0
    seconds: float = 0.0
    attempted: int = 0
    completed_in_window: int = 0
    # (host start, host end, rows) of each dispatch
    dispatches: List[tuple] = dataclasses.field(default_factory=list)
    # what each batch brought back and the pool indices of its frames, in
    # the order of its rows, for the check
    answers: List[Any] = dataclasses.field(default_factory=list)
    frame_ids: List[np.ndarray] = dataclasses.field(default_factory=list)
    counters: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(list))

    @property
    def images_per_s(self) -> float:
        return self.completed_in_window / self.seconds


def batch_start(k: int, b: int, p: int) -> int:
    """Where batch ``k`` of ``b`` consecutive frames starts in a pool of
    ``p``, wrapping at its end. Each batch starts one frame further on than
    a whole batch: where ``b + 1`` and ``p`` share no factor, as at every
    cell's sizes, ``p`` batches put every frame of the pool once into each
    row of a batch, so a fault in one row meets every frame."""
    return (k * (b + 1)) % p


def cycle(b: int, p: int):
    """(pool index, row of its batch) of every frame of ``p`` batches in
    turn: the rows a whole cycle of the loop dispatches."""
    ids = np.concatenate([(batch_start(k, b, p) + np.arange(b)) % p
                          for k in range(p)])
    return ids, np.tile(np.arange(b), p)


def feed(pool: np.ndarray, b: int, host_memory: str = "pageable",
         on_card: bool = True):
    """The frames the loop hands the system: ``pool`` with its first batch
    repeated at its end, so that a batch never wraps. ``host_memory``
    "pinned" puts them in page-locked memory, as a loader with pinned
    memory hands its batches over, so that each upload is one DMA;
    "pageable" leaves them in numpy memory, which the upload stages
    through the host. Without a card there is nothing to pin."""
    ring = np.concatenate((pool, pool[:b]))
    if host_memory == "pinned":
        if not on_card:
            return ring
        import torch
        return torch.from_numpy(ring).pin_memory()
    if host_memory != "pageable":
        raise ValueError(f"unknown host_memory {host_memory!r}")
    return ring


def closed_loop(system, ring, seconds: float, depth: int) -> Window:
    """Batches of ``system.batch`` frames in turn from ``ring`` (``feed``),
    ``depth`` in flight, for ``seconds``; the window counts the frames
    whose results reached the host before it closed. Batches in flight
    when it closes are copied back after it and checked, not counted."""
    b = system.batch
    p = len(ring) - b
    win = Window(seconds=seconds)
    inflight: collections.deque = collections.deque()

    def resolve(end: float) -> None:
        handle, first = inflight.popleft()
        with record_function("bench:resolve"):
            host = system.fetch(handle)
        done = time.perf_counter()
        if done <= end:
            win.completed_in_window += b
        win.answers.append(host)
        win.frame_ids.append(np.arange(first, first + b) % p)

    k = 0
    with record_function("bench:window"):
        win.start = start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            first = batch_start(k, b, p)
            t0 = time.perf_counter()
            with record_function("bench:dispatch"):
                handle = system.dispatch(ring[first:first + b])
            win.dispatches.append((t0, time.perf_counter(), b))
            system.count(win.counters)
            inflight.append((handle, first))
            k += 1
            if len(inflight) >= depth:
                resolve(end)
    while inflight:
        resolve(end)
    win.attempted = k * b
    return win


def frame_ids(win: Window) -> np.ndarray:
    """The pool index of every answered frame, in answer order."""
    if not win.frame_ids:
        return np.zeros(0, np.int64)
    return np.concatenate(win.frame_ids).astype(np.int64)


def slots(win: Window) -> np.ndarray:
    """The row of its batch that each answered frame was dispatched in, in
    answer order."""
    if not win.frame_ids:
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(len(f)) for f in win.frame_ids])
