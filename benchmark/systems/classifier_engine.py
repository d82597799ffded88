"""A fixed-batch classifier ``Engine`` of ``rtdm_tpu_torch`` (bf16, fp32
or int8 engine directories), called as its users call it: uint8 NHWC
frames to ``Engine.dispatch``, the float32 softmax rows copied back as
``Engine.__call__`` copies them."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np

from benchmark import loops


class System:
    fit = "resize"

    def __init__(self, config: Dict, root: str, device, phases: Dict,
                 batch: int = 0):
        t0 = time.perf_counter()
        if str(device).startswith("cuda"):
            from rtdm_tpu_torch.ops import kernels
            kernels.build("acff")     # compiles on a checkout's first run
        phases["acff_library_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        from rtdm_tpu_torch.export.engine import Engine
        self.engine = Engine.load(os.path.join(root, config["engine"]),
                                  device=device)
        if batch:                     # the CPU tests run a smaller batch
            self.engine.spec.batch_size = batch
        self.batch = self.engine.spec.batch_size
        self.size = self.engine.spec.image_size
        phases["engine_load_s"] = time.perf_counter() - t0

    def dispatch(self, frames: np.ndarray):
        return self.engine.dispatch(frames)

    def fetch(self, handle) -> np.ndarray:
        return handle.cpu().numpy()

    def count(self, counters: Dict[str, List[float]]) -> None:
        pass

    def warmup(self, ring) -> None:
        """Full batches from the frames the loop hands over, each copied
        back."""
        for _ in range(3):
            self.fetch(self.dispatch(ring[:self.batch]))

    def answers(self, win) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows (N, classes), pool index of each, row of its batch)."""
        if not win.answers:
            return (np.zeros((0, 0), np.float32), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        rows = [np.asarray(a, np.float32) for a in win.answers]
        return np.concatenate(rows), loops.frame_ids(win), loops.slots(win)
