"""The port's schedules, optimizers and plateau scaler against the JAX
package's (optax).

- ``onecycle_schedule`` and ``cosine_schedule`` step for step within 1e-6
  relative (both fp32; numpy's cos against XLA's), the plateau scaler's
  scales equal.
- ``make_optimizer`` against ``rtdm_tpu.train.schedules.make_optimizer``
  for adam, adamw and sgd on one seeded sequence of gradients (one of them
  clipped, one under the clip) with the kernel-only mask: parameters after
  each update within 1e-6 relative of each leaf's largest for sgd, 2e-5
  for adam and adamw (optax scales the second moment by fp32(1 - b2) but
  corrects it by 1 - fp32(b2)^t, 1.3e-5 apart at t = 1, where torch uses
  one double value: the early updates differ by 6.4e-6 relative), the
  learning rate of each update equal to the one optax injected. Controls: the
  decay on every parameter (BatchNorm's scale too) misses the gate for
  adam and sgd; and on a clipped step torch's ``clip_grad_norm_`` (norm +
  1e-6) misses the optax clip that the port meets.
- The reference's adamw decays nothing (optax's ``inject_hyperparams``
  evaluates the callable mask as a schedule): the port's AdamW runs with
  weight decay 0 and equals it.
- The decay group holds every conv and dense kernel and no BatchNorm
  weight.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from rtdm_tpu.train import schedules as js
from rtdm_tpu_torch.models import create_model
from rtdm_tpu_torch.models.acff import ACFF
from rtdm_tpu_torch.models.io import (flatten_tree,
                                      variables_from_torch_state_dict)
from rtdm_tpu_torch.models.layers import BatchNorm, Conv, Dense
from rtdm_tpu_torch.train import schedules as ts

PARAM_TOL = {"sgd": 1e-6, "adam": 2e-5, "adamw": 2e-5}


@pytest.mark.parametrize("total,pct", [(100, 0.1), (37, 0.3), (4, 0.5),
                                       (2, 0.1), (10, 0.05)])
def test_onecycle_matches_jax(total, pct):
    want = js.onecycle_schedule(3e-3, total, pct_start=pct)
    got = ts.onecycle_schedule(3e-3, total, pct_start=pct)
    steps = range(total + 3)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6)


@pytest.mark.parametrize("total", [1, 7, 100])
def test_cosine_and_make_schedule_match_jax(total):
    for name in ("onecycle", "cosine"):
        want = js.make_schedule(name, 1e-2, total, 0.2, 1e-5)
        got = ts.make_schedule(name, 1e-2, total, 0.2, 1e-5)
        steps = range(total + 3)
        np.testing.assert_allclose([got(s) for s in steps],
                                   [float(want(jnp.asarray(s)))
                                    for s in steps], rtol=1e-6)
    assert ts.make_schedule("reduce", 0.1, total) == 0.1
    with pytest.raises(ValueError):
        ts.make_schedule("step", 0.1, total)


def test_plateau_scaler_matches_jax():
    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(2, 1, 5), 1 + rng.uniform(
        0, 0.01, 30), np.linspace(0.9, 0.5, 5), np.ones(25)])
    a = js.PlateauScaler(patience=3, min_lr=1e-6, base_lr=1e-3)
    b = ts.PlateauScaler(patience=3, min_lr=1e-6, base_lr=1e-3)
    got = [b.update(float(m)) for m in metrics]
    assert got == [a.update(float(m)) for m in metrics]
    assert min(got) == pytest.approx(1e-3)    # the floor, min_lr / base_lr


class _Tiny(torch.nn.Module):
    """A conv, an ACFF block (depthwise and 1x1 kernels, biases, a
    BatchNorm) and a dense layer: every kind of leaf the mask sorts."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 4, 3, use_bias=False)
        self.acff1 = ACFF(4, 8, 0.0)
        self.fc = Dense(8, 5)


def _jax_tree(model):
    state = {n: p.detach().clone() for n, p in model.named_parameters()}
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.array(a)),
        variables_from_torch_state_dict(state)["params"])


def _grads(model, rng, scales):
    """One gradient set a scale: seeded normals, scaled to global norm
    ``scale``, as {name: array} in the port's names."""
    out = []
    for scale in scales:
        g = {n: rng.normal(size=p.shape).astype(np.float32)
             for n, p in model.named_parameters()}
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for v in g.values()))
        out.append({n: v * np.float32(scale / norm) for n, v in g.items()})
    return out


def _run(name, clip, scales, decay_all=False, lr=None):
    """Both optimizers over the same gradient sequence; per update the
    port's and optax's parameters (JAX layout) and learning rates."""
    torch.manual_seed(0)
    model = _Tiny()
    rng = np.random.default_rng(1)
    seq = _grads(model, rng, scales)
    sched = lr or js.make_schedule("onecycle", 5e-2, 6, 0.3)
    tx = js.make_optimizer(name, sched, 0.01, 0.9, clip)
    params = _jax_tree(model)
    opt_state = tx.init(params)
    port = ts.make_optimizer(name, lr or ts.make_schedule(
        "onecycle", 5e-2, 6, 0.3), 0.01, 0.9, clip,
        decay_kernels_only=not decay_all)
    opt = port.init(model)
    rows = []
    for k, grads in enumerate(seq):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        port.step(opt, k)
        jg = jax.tree_util.tree_map(
            jnp.asarray, variables_from_torch_state_dict(
                {n: torch.from_numpy(v) for n, v in grads.items()})["params"])
        updates, opt_state = tx.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        rows.append((flatten_tree(_jax_tree(model)),
                     flatten_tree(jax.device_get(params)),
                     ts_lr(opt), js_lr(opt_state)))
    return rows


def ts_lr(opt):
    return opt.param_groups[0]["lr"]


def js_lr(opt_state):
    from rtdm_tpu.cli.aider_train import current_lr
    return current_lr(opt_state)


def _gap(got, want):
    return max(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
               for k, w in want.items())


SCALES = (3.0, 0.5, 2.0, 0.01, 1.5)    # clip 1.0: steps 0, 2, 4 clipped


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax(name):
    for got, want, lr_got, lr_want in _run(name, 1.0, SCALES):
        assert _gap(got, want) <= PARAM_TOL[name]
        assert lr_got == pytest.approx(lr_want, rel=1e-6)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_gate_fails_decaying_batchnorm(name):
    rows = _run(name, 1.0, SCALES, decay_all=True)
    assert max(_gap(got, want) for got, want, _, _ in rows) > \
        PARAM_TOL[name]


def test_reference_adamw_decays_nothing():
    """optax's adamw through the JAX factory equals adamw with no decay,
    and so does the port's."""
    params = {"a": {"kernel": jnp.ones((3,)), "bias": jnp.ones((3,))}}
    grads = jax.tree_util.tree_map(jnp.zeros_like, params)
    tx = js.make_optimizer("adamw", 0.1, weight_decay=0.5, grad_clip=None)
    updates, _ = tx.update(grads, tx.init(params), params)
    assert all(float(jnp.abs(u).max()) == 0.0
               for u in jax.tree_util.tree_leaves(updates))
    port = ts.make_optimizer("adamw", 0.1, weight_decay=0.5)
    model = _Tiny()
    opt = port.init(model)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.0, 0.0]


def test_clip_is_optax_not_clip_grad_norm():
    """On a clipped step (global norm 2e-3 over a clip of 1e-3) the port's
    clip equals optax's within fp32 rounding; torch's clip_grad_norm_,
    which divides by norm + 1e-6, is 5e-4 off."""
    model = _Tiny()
    grads = _grads(model, np.random.default_rng(2), (2e-3,))[0]
    want = flatten_tree(jax.device_get(optax.clip_by_global_norm(1e-3).update(
        {n: jnp.asarray(v) for n, v in grads.items()}, None)[0]))
    port = ts.make_optimizer("sgd", 0.1, grad_clip=1e-3)
    mine = {n: torch.from_numpy(v.copy()) for n, v in grads.items()}
    norm = port.clip(list(mine.values()))
    assert float(norm) == pytest.approx(2e-3, rel=1e-6)
    theirs = {n: torch.from_numpy(v.copy()).requires_grad_()
              for n, v in grads.items()}
    for t in theirs.values():
        t.grad = t.detach().clone()
    torch.nn.utils.clip_grad_norm_(list(theirs.values()), 1e-3)
    mine = {n: t.numpy() for n, t in mine.items()}
    theirs = {n: t.grad.numpy() for n, t in theirs.items()}
    assert _gap(mine, want) <= 1e-6
    assert _gap(theirs, want) > 1e-4


def test_decay_group_is_the_kernels():
    model = create_model("squeeze-ernet", device="cpu")
    opt = ts.make_optimizer("sgd", 0.1).init(model)
    decayed = {id(p) for p in opt.param_groups[0]["params"]}
    kernels = {id(m.weight) for m in model.modules()
               if isinstance(m, (Conv, Dense)) or
               type(m).__name__ == "DepthwiseConv"}
    bn = {id(m.weight) for m in model.modules() if isinstance(m, BatchNorm)}
    assert decayed == kernels and not decayed & bn
    assert opt.param_groups[0]["weight_decay"] == 0.01
    assert opt.param_groups[1]["weight_decay"] == 0.0
    # the same leaves JAX's mask keeps
    names = {n for n, p in model.named_parameters() if id(p) in decayed}
    tree = variables_from_torch_state_dict(
        {n: p.detach() for n, p in model.named_parameters()})["params"]
    mask = flatten_tree(js.kernel_only_mask(tree))
    jax_names = {k for k, v in mask.items() if bool(v)}
    port_names = set(flatten_tree(variables_from_torch_state_dict(
        {n: torch.zeros(p.shape) for n, p in model.named_parameters()
         if n in names})["params"]))
    assert jax_names == port_names
