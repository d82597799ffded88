"""Holding one detector's output against another's.

Two runs of an int8 detector that sum their convolutions in different
orders do not give the same boxes: a product that lands one fp32 ulp
apart rounds to the other bf16 neighbour about once in 10^5 values, the
next int8 QDQ turns that into a whole code step, and the step spreads
through every later layer. ``scripts/detector_sensitivity.py`` measures
how far: it runs the committed engines in the port with fp32 and with
float64 convolution sums, and against controls that must fail (the int8
engine with its QDQ left out, the reference's boxes moved by one stride).
So two runs are held to each other detection by detection, not bit for
bit:

- a detection of one run is matched to an unmatched one of the same class
  in the other run whose corners lie within ``BOX_PX`` pixels, the closest
  pair first; a matched pair must agree in confidence within
  ``CONF_TOL``. ``box_rel`` adds that share of the box's longer side to
  the limit, for models whose boxes are not on the scale of their input
  (random weights); the committed engines' gate has none;
- a detection left unmatched is allowed only where a decision of the
  engine lies at its edge: its confidence is under ``conf_thres +
  MARGIN`` (it passed the threshold by little), or NMS kept the other of
  two overlapping candidates that both exist in both runs. The second
  needs each run's candidates (``candidates``, the decoded rows over
  ``conf_thres`` that NMS saw): the unmatched box is a candidate of the
  other run (``BOX_PX``, ``CONF_TOL``), which NMS suppressed there under a
  kept detection of its class (IoU over ``iou_thres``, a score at least
  its own) that is a candidate of this run too. Without candidates only
  the first edge excuses;
- at least ``MIN_MATCHED`` of each run's detections are matched.

``compare_detections`` also reports the strict numbers: frames equal bit
for bit, frames with equal counts, the largest box and confidence
differences of the matched pairs. ``meets_strict`` holds a report to equal
counts and classes, boxes within ``STRICT_BOX_PX`` and confidences within
``STRICT_CONF``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

BOX_PX = 3.0
CONF_TOL = 0.08
MARGIN = 0.05
MIN_MATCHED = 0.9
STRICT_BOX_PX = 1.0
STRICT_CONF = 5e-3
# the engine's NMS takes IoU in fp32 on boxes offset by class * 4096
IOU_EPS = 1e-3


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box against (M, 4) boxes."""
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:4], b[:, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter)
    return inter / np.maximum(union, 1e-9)


def _px(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The largest corner difference of one box against (M, 4+) boxes."""
    return np.abs(b[:, :4] - a[:4]).max(1) if len(b) else np.zeros(0)


def candidates(pred, conf_thres: float, min_wh: float = 2.0,
               max_wh: float = 4096.0) -> List[np.ndarray]:
    """The rows NMS sees, per frame (M, 6) x1, y1, x2, y2, score, cls: the
    decoded ``pred`` (n, N, 5+nc) filtered as ``ops/nms.py::batched_nms``
    filters it (one row a box, its best class)."""
    pred = np.asarray(pred, np.float32)
    xy, wh, obj = pred[..., :2], pred[..., 2:4], pred[..., 4]
    probs = pred[..., 5:] * obj[..., None]
    score, cls = probs.max(-1), probs.argmax(-1)
    ok = ((obj > conf_thres) & (score > conf_thres)
          & ((wh > min_wh) & (wh < max_wh)).all(-1))
    rows = np.concatenate([xy - wh / 2, xy + wh / 2, score[..., None],
                           cls[..., None].astype(np.float32)], -1)
    return [rows[k][ok[k]].astype(np.float64) for k in range(len(pred))]


def per_frame(rows: np.ndarray, frames: Sequence[int]) -> List[np.ndarray]:
    """Candidate rows (M, 7) led by their frame's index -> the (m, 6) rows
    of each of ``frames``."""
    rows = np.asarray(rows, np.float64)
    return [rows[rows[:, 0] == k, 1:] for k in frames]


def _exists(box: np.ndarray, cand: np.ndarray, tol) -> np.ndarray:
    """The candidates (M, 6) that are ``box`` within ``tol(box)`` pixels
    and CONF_TOL."""
    same = cand[cand[:, 5] == box[5]]
    return same[(_px(box, same) <= tol(box))
                & (np.abs(same[:, 4] - box[4]) <= CONF_TOL)]


def _nms_edge(r: np.ndarray, own_cand: np.ndarray, other: np.ndarray,
              other_cand: np.ndarray, iou_thres: float, tol) -> Optional[str]:
    """Why NMS kept another box than ``r`` in the other run, if it did so
    at an edge: ``r`` is a candidate there, suppressed by a kept detection
    that is a candidate of ``r``'s run too."""
    for c in _exists(r, other_cand, tol):
        for d in other[other[:, 5] == r[5]]:
            iou = float(_iou(c, d[None])[0])
            if (iou > iou_thres - IOU_EPS and d[4] >= c[4]
                    and len(_exists(d, own_cand, tol))):
                return (f"NMS kept the other run's conf {d[4]:.4f} (IoU "
                        f"{iou:.3f}) over its candidate {c[4]:.4f}")
    return None


def compare_detections(det_a, count_a, det_b, count_b, conf_thres: float,
                       iou_thres: float,
                       cand_a: Optional[Sequence[np.ndarray]] = None,
                       cand_b: Optional[Sequence[np.ndarray]] = None,
                       box_rel: float = 0.0) -> Dict:
    """Hold run b against run a (det (n, max_det, 6), count (n,); the
    candidates of each run per frame, from ``candidates``, if known);
    returns a report with ``ok`` and the ``failures`` that broke it. Two
    boxes are one where their corners differ by at most BOX_PX plus
    ``box_rel`` of the first box's longer side."""

    def tol(box: np.ndarray) -> float:
        return BOX_PX + box_rel * max(box[2] - box[0], box[3] - box[1])

    det_a, det_b = np.asarray(det_a, np.float64), np.asarray(det_b, np.float64)
    count_a, count_b = np.asarray(count_a), np.asarray(count_b)
    rep = {"frames": int(len(count_a)),
           "bit_equal_frames": 0, "count_equal_frames": 0, "matched": 0,
           "detections": [int(count_a.sum()), int(count_b.sum())],
           "max_box_px": 0.0, "max_conf_diff": 0.0, "min_iou": 1.0,
           "edge_unmatched": [], "failures": []}
    for k in range(len(count_a)):
        a, b = det_a[k, :count_a[k]], det_b[k, :count_b[k]]
        rep["bit_equal_frames"] += int(np.array_equal(det_a[k], det_b[k]))
        rep["count_equal_frames"] += int(len(a) == len(b))
        pairs = sorted((float(_px(r, q[None])[0]), i, j)
                       for i, r in enumerate(a) for j, q in enumerate(b)
                       if q[5] == r[5])
        used_a, used_b = set(), set()
        for px, i, j in pairs:
            if i in used_a or j in used_b or px > tol(a[i]):
                continue
            used_a.add(i)
            used_b.add(j)
            rep["matched"] += 1
            dconf = abs(a[i, 4] - b[j, 4])
            rep["max_box_px"] = max(rep["max_box_px"], px)
            rep["max_conf_diff"] = max(rep["max_conf_diff"], float(dconf))
            rep["min_iou"] = min(rep["min_iou"],
                                 float(_iou(a[i], b[j:j + 1])[0]))
            if dconf > CONF_TOL:
                rep["failures"].append(f"frame {k}: conf {a[i, 4]:.4f} vs "
                                       f"{b[j, 4]:.4f}")
        cands = {"a": None if cand_a is None else cand_a[k],
                 "b": None if cand_b is None else cand_b[k]}
        for who, own, used, other, you in (("a", a, used_a, b, "b"),
                                           ("b", b, used_b, a, "a")):
            for i, r in enumerate(own):
                if i in used:
                    continue
                same = other[other[:, 5] == r[5]]
                near = (f"nearest {_px(r, same).min():.2f} px, IoU "
                        f"{_iou(r, same).max():.3f}" if len(same)
                        else "none of its class")
                row = (f"frame {k}: {who}-only class {int(r[5])} conf "
                       f"{r[4]:.4f} ({near} in the other run)")
                why = None
                if r[4] < conf_thres + MARGIN:
                    why = "under conf_thres + MARGIN"
                elif cands[who] is not None and cands[you] is not None:
                    why = _nms_edge(r, cands[who], other, cands[you],
                                    iou_thres, tol)
                if why:
                    rep["edge_unmatched"].append(f"{row}: {why}")
                else:
                    rep["failures"].append(row)
    least = MIN_MATCHED * max(rep["detections"])
    if rep["matched"] < least:
        rep["failures"].append(f"{rep['matched']} matched of "
                               f"{rep['detections']} detections (at least "
                               f"{least:.1f})")
    rep["ok"] = not rep["failures"]
    return rep


def meets_strict(rep: Dict) -> bool:
    """Equal counts and classes in every frame (every detection matched),
    boxes within STRICT_BOX_PX and confidences within STRICT_CONF."""
    return (rep["ok"] and rep["count_equal_frames"] == rep["frames"]
            and rep["matched"] == max(rep["detections"])
            and rep["max_box_px"] <= STRICT_BOX_PX
            and rep["max_conf_diff"] <= STRICT_CONF)


def summary(rep: Dict) -> str:
    return (f"{rep['bit_equal_frames']}/{rep['frames']} frames bit-equal, "
            f"{rep['count_equal_frames']}/{rep['frames']} equal counts, "
            f"{rep['matched']} matched of {rep['detections']} (max box "
            f"{rep['max_box_px']:.4f} px, max conf "
            f"{rep['max_conf_diff']:.4f}, min IoU {rep['min_iou']:.4f}), "
            f"{len(rep['edge_unmatched'])} unmatched at a decision edge, "
            f"{len(rep['failures'])} failures"
            + (f": {rep['failures'][:3]}" if rep["failures"] else ""))
