"""Classification metrics from confusion counts: accuracy, macro and
weighted F1, precision and recall, and the per-class report.

Counterpart of ``rtdm_tpu/eval/classification.py`` (numpy only, copied so
that the port imports nothing of the JAX package): the caller sums integer
confusion matrices, one small transfer a batch, and every metric is derived
from them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np


@dataclass
class ClassificationMetrics:
    num_classes: int
    class_names: Optional[Sequence[str]] = None
    confusion: np.ndarray = field(init=False)
    loss_sum: float = field(init=False, default=0.0)
    count: int = field(init=False, default=0)

    def __post_init__(self):
        self.confusion = np.zeros((self.num_classes, self.num_classes),
                                  np.int64)

    def update(self, confusion_counts, loss_sum: float = 0.0,
               count: Optional[int] = None) -> None:
        cm = np.asarray(confusion_counts, np.int64)
        self.confusion += cm
        self.count += int(count if count is not None else cm.sum())
        self.loss_sum += float(loss_sum)

    # --- derived metrics (all from the confusion matrix) ---

    @property
    def total(self) -> int:
        return int(self.confusion.sum())

    @property
    def accuracy(self) -> float:
        t = self.total
        return float(np.trace(self.confusion)) / t if t else 0.0

    @property
    def loss(self) -> float:
        return self.loss_sum / self.count if self.count else 0.0

    def per_class(self) -> Dict[str, np.ndarray]:
        cm = self.confusion.astype(np.float64)
        tp = np.diag(cm)
        support = cm.sum(axis=1)
        predicted = cm.sum(axis=0)
        precision = np.divide(tp, predicted, out=np.zeros_like(tp),
                              where=predicted > 0)
        recall = np.divide(tp, support, out=np.zeros_like(tp),
                           where=support > 0)
        denom = precision + recall
        f1 = np.divide(2 * precision * recall, denom,
                       out=np.zeros_like(tp), where=denom > 0)
        return {"precision": precision, "recall": recall, "f1": f1,
                "support": support.astype(np.int64)}

    def _averaged(self, metric: str, average: str) -> float:
        pc = self.per_class()
        vals, support = pc[metric], pc["support"].astype(np.float64)
        if average == "macro":
            return float(vals.mean())
        if average == "weighted":
            tot = support.sum()
            return float((vals * support).sum() / tot) if tot else 0.0
        raise ValueError(average)

    def f1(self, average: str = "weighted") -> float:
        return self._averaged("f1", average)

    def precision(self, average: str = "weighted") -> float:
        return self._averaged("precision", average)

    def recall(self, average: str = "weighted") -> float:
        return self._averaged("recall", average)

    def report(self) -> str:
        names = (list(self.class_names)
                 if self.class_names else
                 [f"class_{i}" for i in range(self.num_classes)])
        pc = self.per_class()
        lines = [f"{'class':>20} {'precision':>9} {'recall':>9} "
                 f"{'f1':>9} {'support':>8}"]
        for i, name in enumerate(names):
            lines.append(f"{name:>20} {pc['precision'][i]:9.4f} "
                         f"{pc['recall'][i]:9.4f} {pc['f1'][i]:9.4f} "
                         f"{pc['support'][i]:8d}")
        lines.append(f"{'accuracy':>20} {self.accuracy:9.4f}   "
                     f"(weighted F1 {self.f1('weighted'):.4f}, "
                     f"macro F1 {self.f1('macro'):.4f})")
        return "\n".join(lines)
