"""A detector engine of ``rtdm_tpu_torch`` (``export/detector.py``), called
as its users call it: letterboxed uint8 NHWC frames to ``Detector.submit``
at the batch the configuration gives ``load_detector``, the detections
copied back as ``Detector.__call__`` copies them."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np

from benchmark import loops


class System:
    fit = "letterbox"

    def __init__(self, config: Dict, root: str, device, phases: Dict,
                 batch: int = 0):
        phases["acff_library_s"] = 0.0     # no detector reaches ACFF
        t0 = time.perf_counter()
        from rtdm_tpu_torch.export.detector import load_detector
        self.det = load_detector(os.path.join(root, config["engine"]),
                                 device=device,
                                 batch_size=batch or int(config["batch"]))
        self.batch = self.det.batch_size
        self.size = self.det.spec.img_size
        phases["engine_load_s"] = time.perf_counter() - t0

    def dispatch(self, frames: np.ndarray):
        return self.det.submit(frames)

    def fetch(self, handle):
        """The copy back of ``Detector.__call__``; the rows past the
        batch's largest count (all zero) are then dropped, so the window's
        answers stay small."""
        det, count, n = handle
        det, count = det[:n].cpu().numpy(), count[:n].cpu().numpy()
        return det[:, :int(count.max(initial=0))].copy(), count

    def count(self, counters: Dict[str, List[float]]) -> None:
        steps = self.det.stats.get("greedy_steps")
        if steps is not None:
            counters["greedy_steps"].append(float(steps))

    def warmup(self, ring) -> None:
        """Full batches from the frames the loop hands over, each copied
        back."""
        for _ in range(3):
            self.fetch(self.dispatch(ring[:self.batch]))

    def answers(self, win) -> Tuple[List[np.ndarray], np.ndarray,
                                    np.ndarray]:
        """(each answer's (k, 6) detections, pool index of each, row of its
        batch)."""
        out: List[np.ndarray] = []
        for det, count in win.answers:
            out.extend(det[i, :int(c)] for i, c in enumerate(count))
        return out, loops.frame_ids(win), loops.slots(win)
