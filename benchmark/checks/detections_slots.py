"""Each answered frame's detections against the reference's detections of
the same frame, over every answer and over each row of a batch.

``unmatched_share``, ``conf_gap`` and ``missing`` are ``detections.py``'s
(the same pairing, by its ``match``). Besides:

- ``unmatched_slot_max``: the largest over the rows of a batch of the
  unmatched share of the answers dispatched in that row (their detections
  of either side left unpaired, over all detections of both sides). A
  fault in one row of every batch moves ``unmatched_share`` by a batch's
  share only; here it moves a whole row's.

Identical answers for one frame are compared once and counted in each row
as often as they came there.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from benchmark.checks.detections import match


def compare(answers: Sequence[np.ndarray], frame_ids: Sequence[int],
            slots: Sequence[int], reference: List[np.ndarray],
            missing: int = 0) -> Dict[str, float]:
    """``answers``: each answer's (k, 6) detections; ``frame_ids`` its pool
    index; ``slots`` the row of its batch it was dispatched in;
    ``reference``: the pool's detections."""
    seen: Dict[tuple, Counter] = {}
    for f, s, a in zip(frame_ids, slots, answers):
        key = (int(f), np.asarray(a, np.float32).tobytes())
        seen.setdefault(key, Counter())[int(s)] += 1
    rows = max((s for c in seen.values() for s in c), default=-1) + 1
    unpaired, total = np.zeros(rows), np.zeros(rows)
    gap = 0.0
    for (f, raw), in_rows in seen.items():
        prog = np.frombuffer(raw, np.float32).reshape(-1, 6)
        _, u, g = match(prog, reference[f])
        gap = max(gap, g)
        for s, times in in_rows.items():
            unpaired[s] += times * u
            total[s] += times * (len(prog) + len(reference[f]))
    if not seen:
        return {"unmatched_share": float("inf"), "conf_gap": 0.0,
                "missing": float(missing), "unmatched_slot_max": float("inf")}
    share = np.divide(unpaired, total, out=np.zeros(rows), where=total > 0)
    return {"unmatched_share": float(unpaired.sum() / total.sum()
                                     if total.sum() else 0.0),
            "conf_gap": float(gap), "missing": float(missing),
            "unmatched_slot_max": float(share.max())}
