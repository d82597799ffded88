"""Each answered frame's softmax row against the reference's row for the
same frame.

- ``prob_l1_mean``: the mean over every answer of the L1 distance between
  the served probabilities and the reference's. The widest single gap is
  no use here: a bf16 engine's logits are large, so a frame whose two best
  classes are within its rounding flips between them, and a control in a
  lower precision reads no worse on that one number;
- ``prob_l1_slot_max``: the largest over the rows of a batch of the mean
  L1 distance of the answers dispatched in that row. A fault in one row of
  every batch (a tile's edge, a last row sent astray) moves the mean over
  all answers by a batch's share only; here it moves a whole row's mean;
- ``missing``: answers that never came or failed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def compare(answers: np.ndarray, frame_ids: np.ndarray, slots: np.ndarray,
            reference: np.ndarray, missing: int = 0) -> Dict[str, float]:
    """``answers`` (N, classes), ``frame_ids`` (N,) pool indices, ``slots``
    (N,) the row of its batch each was dispatched in, ``reference`` (pool,
    classes)."""
    if len(answers) == 0:
        return {"prob_l1_mean": float("inf"),
                "prob_l1_slot_max": float("inf"), "missing": float(missing)}
    l1 = np.abs(np.asarray(answers, np.float64)
                - reference[np.asarray(frame_ids)].astype(np.float64)).sum(1)
    slots = np.asarray(slots)
    per_slot = np.bincount(slots, l1) / np.maximum(np.bincount(slots), 1)
    return {"prob_l1_mean": float(l1.mean()),
            "prob_l1_slot_max": float(per_slot.max()),
            "missing": float(missing)}
