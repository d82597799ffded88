"""The port's classification losses and batch mixing against the JAX
package: every loss (cross entropy with and without class weights, label
smoothing, focal with and without alpha) at every reduction with rows at
``ignore_index``, the class weights, the loss factory, and mixup / cutmix
applied on the values the JAX keys drew.

Tolerance: losses within 1e-6 relative (fp32, the same formula; only the
order of a few sums differs); the mixing applies bit for bit (mixup within
1e-6: XLA may fuse its blend). Controls: a loss with the label smoothing
left out, mixing with lam and 1 - lam swapped, and a cutmix box one row
off each miss them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtdm_tpu.train import batch_augment as jba
from rtdm_tpu.train import losses as jl
from rtdm_tpu_torch.train import batch_augment as tba
from rtdm_tpu_torch.train import losses as tl

REDUCTIONS = ("mean", "sum", "none")


def _inputs(rng, n=12, c=5):
    logits = rng.normal(0, 3, (n, c)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[[1, 7]] = -100
    weights = rng.uniform(0.2, 2.0, c).astype(np.float32)
    return logits, labels, weights


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=1e-7)


CASES = {
    "ce": lambda m, lg, lb, w, r: m.cross_entropy(lg, lb, reduction=r),
    "ce_weighted": lambda m, lg, lb, w, r: m.cross_entropy(
        lg, lb, weights=w, reduction=r),
    "label_smoothing": lambda m, lg, lb, w, r:
        m.label_smoothing_cross_entropy(lg, lb, epsilon=0.1, reduction=r),
    "focal": lambda m, lg, lb, w, r: m.focal_loss(lg, lb, gamma=2.0,
                                                  reduction=r),
    "focal_alpha": lambda m, lg, lb, w, r: m.focal_loss(
        lg, lb, gamma=1.5, alpha=w, reduction=r),
}


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax(rng, case, reduction):
    logits, labels, weights = _inputs(rng)
    want = CASES[case](jl, jnp.asarray(logits), jnp.asarray(labels),
                       weights, reduction)
    got = CASES[case](tl, torch.from_numpy(logits),
                      torch.from_numpy(labels).long(), weights, reduction)
    _close(got, want)
    if reduction == "none":
        assert np.all(np.asarray(got)[[1, 7]] == 0)     # ignore_index


def test_loss_gate_fails_without_smoothing(rng):
    logits, labels, _ = _inputs(rng)
    want = jl.label_smoothing_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels))
    got = tl.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels).long())
    with pytest.raises(AssertionError):
        _close(got, want)


@pytest.mark.parametrize("name", ["crossentropy", "label_smoothing_ce",
                                  "focal"])
def test_factory_matches_jax(rng, name):
    logits, labels, _ = _inputs(rng)
    labels[[1, 7]] = 0
    weights = jl.inverse_frequency_class_weights(labels, 5)
    np.testing.assert_array_equal(
        tl.inverse_frequency_class_weights(labels, 5), weights)
    jf = jl.make_classification_loss(name, 0.2, 1.5, weights)
    tf = tl.make_classification_loss(name, 0.2, 1.5, weights)
    for reduction in REDUCTIONS:
        _close(tf(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                  reduction=reduction),
               jf(jnp.asarray(logits), jnp.asarray(labels),
                  reduction=reduction))
    with pytest.raises(ValueError):
        tl.make_classification_loss("hinge")


def test_class_weights_sum_to_one():
    w = tl.inverse_frequency_class_weights([0, 0, 0, 1, 2, 2], 5)
    assert abs(w.sum() - 1.0) < 1e-6
    assert w[0] < w[2] < w[1] == w[3] == w[4]    # empty classes count once


def _images(rng):
    return rng.normal(size=(6, 12, 10, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_mixup_apply_on_jax_draws(rng, seed):
    images = _images(rng)
    mixed, perm, lam = jba.mixup_batch(jax.random.key(seed),
                                       jnp.asarray(images), 0.4)
    lam = float(lam)
    got = tba.mixup_apply(torch.from_numpy(images), np.asarray(perm), lam)
    _close(got, mixed)
    swapped = tba.mixup_apply(torch.from_numpy(images), np.asarray(perm),
                              1.0 - lam)
    with pytest.raises(AssertionError):
        _close(swapped, mixed)


def _jax_cutmix_box(key, h, w, alpha):
    """The box the JAX ``cutmix_batch`` draws from ``key`` (its own steps)."""
    k1, k2, k3, _ = jax.random.split(key, 4)
    cut = jnp.sqrt(1.0 - jax.random.beta(k1, alpha, alpha))
    ch, cw = (h * cut).astype(jnp.int32), (w * cut).astype(jnp.int32)
    cy = jax.random.randint(k2, (), 0, h)
    cx = jax.random.randint(k3, (), 0, w)
    return tuple(int(v) for v in (jnp.clip(cy - ch // 2, 0, h),
                                  jnp.clip(cy + ch // 2, 0, h),
                                  jnp.clip(cx - cw // 2, 0, w),
                                  jnp.clip(cx + cw // 2, 0, w)))


@pytest.mark.parametrize("seed", range(6))
def test_cutmix_apply_on_jax_draws(rng, seed):
    images = _images(rng)
    key = jax.random.key(seed)
    mixed, perm, lam = jba.cutmix_batch(key, jnp.asarray(images), 1.0)
    box = _jax_cutmix_box(key, 12, 10, 1.0)
    got, got_lam = tba.cutmix_apply(torch.from_numpy(images),
                                    np.asarray(perm), box)
    np.testing.assert_array_equal(got.numpy(), np.asarray(mixed))
    assert np.float32(got_lam) == np.float32(lam)
    y1, y2, x1, x2 = box
    off = (y1 + 1, min(y2 + 1, 12), x1, x2) if y2 > y1 else (0, 1, 0, 10)
    moved, _ = tba.cutmix_apply(torch.from_numpy(images), np.asarray(perm),
                                off)
    assert not np.array_equal(moved.numpy(), np.asarray(mixed))


def test_draws_stay_in_range():
    rng = np.random.default_rng(3)
    for _ in range(50):
        lam, perm = tba.draw_mixup(rng, 8, 0.2)
        assert 0.0 <= lam <= 1.0 and sorted(perm) == list(range(8))
        perm, (y1, y2, x1, x2) = tba.draw_cutmix(rng, 8, 14, 10, 0.1)
        assert 0 <= y1 <= y2 <= 14 and 0 <= x1 <= x2 <= 10
        assert sorted(perm) == list(range(8))
