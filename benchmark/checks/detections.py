"""Each answered frame's detections against the reference's detections of
the same frame.

Detections of one class are paired greedily, the highest IoU first, down
to ``MATCH_IOU``. Over every answer:

- ``unmatched_share``: the detections of either side left unpaired, over
  all detections of both sides (a detection that passes the confidence
  threshold or NMS by a hair in one and not the other is one of these);
- ``conf_gap``: the largest confidence difference of a pair;
- ``missing``: answers that never came or failed.

Identical answers for one frame are compared once and counted as often as
they came.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

MATCH_IOU = 0.5


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def match(prog: np.ndarray, ref: np.ndarray) -> Tuple[int, int, float]:
    """(pairs, unpaired detections of both sides, largest confidence gap of
    a pair) of one frame's (k, 6) rows x1, y1, x2, y2, conf, cls."""
    pairs, gap = 0, 0.0
    for cls in np.union1d(prog[:, 5], ref[:, 5]):
        p = prog[prog[:, 5] == cls].astype(np.float64)
        r = ref[ref[:, 5] == cls].astype(np.float64)
        if len(p) == 0 or len(r) == 0:
            continue
        iou = _iou_matrix(p, r)
        while True:
            i, j = np.unravel_index(np.argmax(iou), iou.shape)
            if iou[i, j] < MATCH_IOU:
                break
            pairs += 1
            gap = max(gap, abs(p[i, 4] - r[j, 4]))
            iou[i, :] = -1.0
            iou[:, j] = -1.0
    return pairs, len(prog) + len(ref) - 2 * pairs, gap


def compare(answers: Sequence[np.ndarray], frame_ids: Sequence[int],
            slots: Sequence[int], reference: List[np.ndarray],
            missing: int = 0) -> Dict[str, float]:
    """``answers``: each answer's (k, 6) detections; ``frame_ids`` its pool
    index; ``reference``: the pool's detections. ``slots``, the row of its
    batch each answer was dispatched in, is not read: each frame is judged
    by its own detections, wherever it sat."""
    seen = Counter((int(f), a.astype(np.float32).tobytes())
                   for f, a in zip(frame_ids, answers))
    unpaired, total, gap = 0, 0, 0.0
    for (f, raw), times in seen.items():
        prog = np.frombuffer(raw, np.float32).reshape(-1, 6)
        _, u, g = match(prog, reference[f])
        unpaired += times * u
        total += times * (len(prog) + len(reference[f]))
        gap = max(gap, g)
    share = unpaired / total if total else 0.0
    if not seen:
        share = float("inf")
    return {"unmatched_share": float(share), "conf_gap": float(gap),
            "missing": float(missing)}
