"""Hyperparameter evolution: the reference's genetic search.

Counterpart of ``rtdm_tpu/train/evolve.py``, in numpy, draw for draw
(yolov3/train.py:444-491, yolov5/train.py:543-625,
yolov5/utils/general.py:603-627 print_mutation):

- evolve.txt rows are 7 result columns (P, R, mAP@0.5,
  mAP@0.5:0.95-or-F1, and three losses) and then the genes in genome
  order; the file is kept unique and sorted by fitness after every
  generation.
- ``select_parent`` draws one of the top min(5, n) rows with probability
  proportional to ``fitness - fitness.min()`` ('single'), or blends them
  with those weights ('weighted').
- ``mutate`` is the reference's method 3: per-gene factors
  ``(g * (rand < mp) * randn * rand * s + 1).clip(0.3, 3)``, drawn again
  until one gene changes, then each gene clipped to its (lo, hi) and
  rounded to 5 decimals; mp 0.8 for v5, 0.9 for v3, s 0.2.
- ``EvolveLog.save_yaml`` writes ``hyp_evolved.yaml`` with the port's own
  YAML writer (``utils/yaml_io.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

N_RESULT_COLS = 7  # (P, R, mAP@0.5, mAP-or-F1, val losses x3)

# v5 fitness: 0.1*mAP@0.5 + 0.9*mAP@0.5:0.95 (yolov5/utils/metrics.py:12)
FITNESS_W_V5 = (0.0, 0.0, 0.1, 0.9)
# v3 fitness: 0.01*R + 0.99*mAP@0.5 (yolov3/utils/utils.py:838-841)
FITNESS_W_V3 = (0.0, 0.01, 0.99, 0.0)

# v5 genome — the reference meta (yolov5/train.py:547-574) restricted to
# genes this trainer consumes (no flipud/perspective augs; the 'anchors'
# gene rewrites head anchor counts, which is a model-structure change the
# compiled-shape design intentionally excludes). (gain, lo, hi).
V5_EVOLVE_META: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
}

# v3 genome — the reference's 18-gene hyp dict (yolov3/train.py:27-44) in
# order, gains from its g array (:467), limits from its clip list (:481-484;
# unclipped genes get wide pass-through bounds).
V3_EVOLVE_META: Dict[str, Tuple[float, float, float]] = {
    "giou": (1, 0.0, 10.0),
    "cls": (1, 0.0, 500.0),
    "cls_pw": (1, 0.1, 10.0),
    "obj": (1, 0.0, 500.0),
    "obj_pw": (1, 0.1, 10.0),
    "iou_t": (1, 0.0, 0.70),
    "lr0": (1, 1e-5, 1e-2),
    "lrf": (0, -5.0, -1.0),
    "momentum": (0.1, 0.60, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "fl_gamma": (0, 0.0, 3.0),
    "hsv_h": (1, 0.0, 0.9),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
}


def fitness(x: np.ndarray, w: Sequence[float] = FITNESS_W_V5) -> np.ndarray:
    """Weighted metric combination over the first 4 result columns."""
    x = np.atleast_2d(np.asarray(x, float))
    return (x[:, :4] * np.asarray(w, float)).sum(1)


def select_parent(rows: np.ndarray, rng: np.random.Generator,
                  n: int = 5, parent: str = "single",
                  w_fit: Sequence[float] = FITNESS_W_V5) -> np.ndarray:
    """Pick the next generation's parent row from evolve.txt rows.

    'single' (reference default): fitness-weighted draw from the top n.
    'weighted': fitness-weighted blend of the top n. Returns the full row
    (results + genes). When every top-n fitness ties the weights are all
    zero — the reference's random.choices would raise; degrade to uniform.
    """
    rows = np.atleast_2d(np.asarray(rows, float))
    n = min(n, len(rows))
    top = rows[np.argsort(-fitness(rows, w_fit))][:n]
    w = fitness(top, w_fit) - fitness(top, w_fit).min()
    if parent == "single" or len(top) == 1:
        if w.sum() <= 0:
            return top[int(rng.integers(0, len(top)))]
        return top[int(rng.choice(len(top), p=w / w.sum()))]
    if parent != "weighted":
        raise ValueError(f"parent must be 'single' or 'weighted': {parent}")
    return (top * w.reshape(-1, 1)).sum(0) / w.sum()


def mutate(parent_genes: Mapping[str, float],
           meta: Mapping[str, Tuple[float, float, float]],
           rng: np.random.Generator, mp: float = 0.8,
           s: float = 0.2) -> Dict[str, float]:
    """Reference method-3 mutation of a gene dict (see module doc)."""
    keys = list(meta)
    g = np.array([meta[k][0] for k in keys], float)
    ng = len(keys)
    v = np.ones(ng)
    while np.all(v == 1):  # re-draw until a change occurs (train.py:604)
        v = (g * (rng.random(ng) < mp) * rng.standard_normal(ng)
             * rng.random() * s + 1).clip(0.3, 3.0)
    child: Dict[str, float] = {}
    for i, k in enumerate(keys):
        _, lo, hi = meta[k]
        child[k] = round(float(np.clip(
            float(parent_genes[k]) * v[i], lo, hi)), 5)
    return child


class EvolveLog:
    """evolve.txt + hyp_evolved.yaml maintenance (print_mutation)."""

    def __init__(self, path: str,
                 meta: Mapping[str, Tuple[float, float, float]],
                 w_fit: Sequence[float] = FITNESS_W_V5):
        self.path = path
        self.keys = list(meta)
        self.w_fit = tuple(w_fit)

    def load(self) -> Optional[np.ndarray]:
        if not os.path.exists(self.path):
            return None
        rows = np.loadtxt(self.path, ndmin=2)
        return rows if rows.size else None

    def append(self, hyp: Mapping[str, float],
               results: Sequence[float]) -> None:
        """Append one generation and re-sort the file by fitness
        (general.py:611-615: unique rows, descending fitness)."""
        results = list(results)
        if len(results) != N_RESULT_COLS:
            raise ValueError(f"expected {N_RESULT_COLS} result columns, "
                             f"got {len(results)}")
        row = results + [float(hyp[k]) for k in self.keys]
        with open(self.path, "a") as f:
            # explicit separator: a 10-char value (e.g. 2.7554e-07)
            # fills the whole %10.5g field and would otherwise merge
            # with its neighbour, breaking np.loadtxt
            f.write(" ".join("%10.5g" % v for v in row) + "\n")
        x = np.unique(np.loadtxt(self.path, ndmin=2), axis=0)
        x = x[np.argsort(-fitness(x, self.w_fit))]
        np.savetxt(self.path, x, "%10.5g")

    def genes_of(self, row: np.ndarray) -> Dict[str, float]:
        return {k: float(row[N_RESULT_COLS + i])
                for i, k in enumerate(self.keys)}

    def best(self) -> Optional[Dict[str, float]]:
        rows = self.load()
        if rows is None:
            return None
        return self.genes_of(rows[np.argmax(fitness(rows, self.w_fit))])

    def save_yaml(self, yaml_file: str) -> None:
        """Best row -> hyp_evolved.yaml with the results header comment
        (general.py:617-624)."""
        from rtdm_tpu_torch.utils import yaml_io
        rows = self.load()
        if rows is None:
            return
        best_row = rows[np.argmax(fitness(rows, self.w_fit))]
        hdr = ("# Hyperparameter Evolution Results\n"
               f"# Generations: {len(rows)}\n# Metrics: "
               + ("%10.4g" * N_RESULT_COLS)
               % tuple(best_row[:N_RESULT_COLS]) + "\n\n")
        with open(yaml_file, "w") as f:
            f.write(hdr)
            f.write(yaml_io.dumps(self.genes_of(best_row), sort_keys=False))
