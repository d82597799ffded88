"""Classification losses on logits.

Counterpart of ``rtdm_tpu/train/losses.py``: cross entropy (per-class
weights, ``ignore_index``), label-smoothing cross entropy, focal loss
(optional per-class alpha), the inverse-frequency class weights normalized
to sum 1, and the factory ``make_classification_loss`` whose losses take
a ``reduction`` ('mean', 'sum' or 'none'). Every loss computes in fp32 and
rows whose label is ``ignore_index`` count for nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _nll(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int):
    """(log-softmax, per-row NLL at the label, valid mask, safe labels)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    return logp, nll, valid, safe


def _class_vector(values, safe: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32),
                           device=safe.device)[safe]


def _reduce(per_example: torch.Tensor, denom: torch.Tensor,
            reduction: str) -> torch.Tensor:
    if reduction == "none":
        return per_example
    if reduction == "sum":
        return per_example.sum()
    if reduction != "mean":
        raise ValueError(f"unknown reduction '{reduction}'")
    return per_example.sum() / denom


def _row_weights(labels: torch.Tensor, weights, ignore_index: int
                 ) -> torch.Tensor:
    """Each row's class weight (1 without weights), 0 at ignore_index."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    w = (_class_vector(weights, safe) if weights is not None
         else torch.ones(labels.shape, device=labels.device))
    return torch.where(valid, w, torch.zeros_like(w))


def mean_denominator(labels: torch.Tensor, weights=None,
                     ignore_index: int = -100, weighted: bool = False
                     ) -> torch.Tensor:
    """What a loss's 'mean' divides its sum by, from the labels alone: the
    sum of the valid rows' class weights (``weighted``: cross entropy), else
    the count of valid rows. A data-parallel step divides each rank's sum
    by the global batch's."""
    if weighted:
        return _row_weights(labels, weights, ignore_index).sum() \
            .clamp_min(1e-8)
    return (labels != ignore_index).sum().clamp_min(1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[Sequence[float]] = None,
                  ignore_index: int = -100,
                  reduction: str = "mean") -> torch.Tensor:
    """CE over valid targets, with optional per-class weights; 'mean'
    divides by the sum of the valid rows' weights."""
    _, nll, _, _ = _nll(logits, labels, ignore_index)
    w = _row_weights(labels, weights, ignore_index)
    return _reduce(nll * w, w.sum().clamp_min(1e-8), reduction)


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  epsilon: float = 0.1,
                                  ignore_index: int = -100,
                                  reduction: str = "mean") -> torch.Tensor:
    """eps * mean(-logp) + (1-eps) * nll, masked at ignore_index."""
    logp, nll, valid, _ = _nll(logits, labels, ignore_index)
    smooth = -logp.mean(-1)
    per_example = epsilon * smooth + (1.0 - epsilon) * nll
    per_example = torch.where(valid, per_example,
                              torch.zeros_like(per_example))
    return _reduce(per_example, valid.sum().clamp_min(1), reduction)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0,
               alpha: Optional[Sequence[float]] = None,
               ignore_index: int = -100,
               reduction: str = "mean") -> torch.Tensor:
    """(1-pt)^gamma * CE, with optional per-class alpha weighting;
    ``ignore_index`` rows are left out."""
    _, nll, valid, safe = _nll(logits, labels, ignore_index)
    pt = torch.exp(-nll)
    focal = torch.pow(1.0 - pt, gamma) * nll
    if alpha is not None:
        focal = focal * _class_vector(alpha, safe)
    focal = torch.where(valid, focal, torch.zeros_like(focal))
    return _reduce(focal, valid.sum().clamp_min(1), reduction)


def inverse_frequency_class_weights(labels: Sequence[int],
                                    num_classes: int) -> np.ndarray:
    """total / (num_classes * count_c), normalized to sum 1 (a class with
    no sample counts as one)."""
    counts = np.bincount(np.asarray(labels),
                         minlength=num_classes).astype(np.float64)
    counts = np.maximum(counts, 1.0)
    w = counts.sum() / (num_classes * counts)
    return (w / w.sum()).astype(np.float32)


def make_classification_loss(name: str,
                             label_smoothing: float = 0.1,
                             focal_gamma: float = 2.0,
                             class_weights: Optional[np.ndarray] = None):
    """'crossentropy' | 'label_smoothing' | 'focal' (and their aliases) ->
    ``loss(logits, labels, reduction='mean')``, whose ``denominator(labels)``
    is what its mean divides the sum by (``mean_denominator``)."""
    name = name.lower().replace("-", "_")
    if name in ("ce", "crossentropy", "cross_entropy"):
        def loss(logits, labels, reduction="mean"):
            return cross_entropy(logits, labels, weights=class_weights,
                                 reduction=reduction)
        loss.denominator = lambda labels: mean_denominator(
            labels, class_weights, weighted=True)
    elif name in ("label_smoothing", "labelsmoothing", "smooth",
                  "label_smoothing_ce"):
        def loss(logits, labels, reduction="mean"):
            return label_smoothing_cross_entropy(
                logits, labels, epsilon=label_smoothing, reduction=reduction)
        loss.denominator = mean_denominator
    elif name == "focal":
        def loss(logits, labels, reduction="mean"):
            return focal_loss(logits, labels, gamma=focal_gamma,
                              alpha=class_weights, reduction=reduction)
        loss.denominator = mean_denominator
    else:
        raise ValueError(f"unknown loss '{name}'")
    return loss
