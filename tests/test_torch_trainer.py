"""The port's trainer against the JAX package's.

- The three cases of ``tests/goldens/torch_port/train.npz`` (the JAX train
  step, three steps each from one Squeeze_ErNET init on one batch of 16,
  grad accumulation 2, clip 1.0, onecycle): per-step loss and grad_norm,
  final params and BatchNorm running statistics. Tolerances, from the
  readings (the port on the CPU; the port in float64 beside it, which
  shows how far the reference's own fp32 rounding is from exact
  arithmetic):

  | case | loss | grad_norm | params (of the largest) | stats (a leaf's) |
  |---|---|---|---|---|
  | a fp32 sgd | 1e-5 (read 1.0e-6) | 3e-5 (1.0e-5; f64 1.4e-5) | 2e-5 (5.8e-6; f64 3.4e-6) | 1e-4 (1.3e-5) |
  | b fp32 adamw | 2e-4 (3.8e-5) | 3e-3 (6.4e-4; f64 7.1e-4) | 5e-3 (1.6e-3; f64 1.6e-3) | 2e-3 (3.3e-4) |
  | c bf16 adamw | 3e-3 (5.9e-4) | 2e-2 (5.5e-3) | 1e-2 (2.8e-3) | 1e-2 (2.8e-3) |

  fp32 cannot hold 1e-5 everywhere: where two values of a 2x2 max-pool
  window tie within an ulp, XLA and torch send the gradient to different
  pixels, and Adam's first updates are lr * sign(g), so an element whose
  gradient is near 0 moves +-lr on that noise; the float64 port is as far
  from the golden as the fp32 one. Controls on case a: weight decay on
  every parameter (BatchNorm's scale too), and BatchNorm momentum 0.9,
  each miss the gates.
- The golden is current: JAX makes its init, its batch and case a again.
- The eval step's masking, confusion counts and loss sum against the JAX
  ``make_eval_step`` (counts equal, loss sum within 1e-5 relative).
- ROADMAP fault 4 (stale kernel arguments): evaluate, take one step,
  evaluate again; the second eval equals the blocks run layer by layer on
  the new weights and differs from the first; an ACFF block's arguments
  follow an in-place change after a train()/eval() switch.
- Checkpoints: save, restore and resume give the uninterrupted run's
  weights, optimizer state and step, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.core.precision import FP32_POLICY, policy_from_name
from rtdm_tpu_torch.data.aider import normalize_batch
from rtdm_tpu_torch.models import create_model
from rtdm_tpu_torch.models.acff import ACFF, layer_by_layer
from rtdm_tpu_torch.models.io import (flatten_tree,
                                      torch_state_dict_from_variables,
                                      unflatten_tree,
                                      variables_from_torch_state_dict)
from rtdm_tpu_torch.models.layers import BatchNorm
from rtdm_tpu_torch.train.checkpoint import CheckpointManager
from rtdm_tpu_torch.train.losses import make_classification_loss
from rtdm_tpu_torch.train.schedules import make_optimizer, make_schedule
from rtdm_tpu_torch.train.trainer import (Trainer, create_train_state,
                                          make_train_step)
from tests.torch_port_goldens import GOLDEN_TRAIN

# case: (loss, grad_norm, params of the largest |param|, stats per leaf)
GATES = {"a": (1e-5, 3e-5, 2e-5, 1e-4), "b": (2e-4, 3e-3, 5e-3, 2e-3),
         "c": (3e-3, 2e-2, 1e-2, 1e-2)}


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN_TRAIN) as g:
        out = dict(g)
    out["spec"] = json.loads(str(out["spec"]))
    out["init"] = unflatten_tree({k[5:]: v for k, v in out.items()
                                  if k.startswith("init/")})
    return out


def _model(golden):
    model = create_model(golden["spec"]["model"], device="cpu",
                         dropout_rate=golden["spec"]["dropout"])
    model.load_state_dict(torch_state_dict_from_variables(golden["init"]))
    return model


def run_case(golden, case, decay_all=False, momentum=None):
    """The port's train step in one golden case: per-step metrics and the
    final variables (flat, JAX layout)."""
    sp = golden["spec"]
    precision, opt, lr = sp["cases"][case]
    model = _model(golden)
    if momentum is not None:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.momentum = momentum
    tx = make_optimizer(opt, make_schedule("onecycle", lr, sp["total_steps"],
                                           sp["warmup_ratio"]),
                        sp["weight_decay"], grad_clip=sp["grad_clip"],
                        decay_kernels_only=not decay_all)
    step = make_train_step(tx, make_classification_loss(
        sp["loss"], label_smoothing=sp["label_smoothing"]),
        policy_from_name(precision), sp["grad_accum_steps"])
    state = create_train_state(model, tx)
    x = normalize_batch(torch.from_numpy(golden["images"]))
    y = torch.from_numpy(golden["labels"]).long()
    metrics = {"loss": [], "accuracy": [], "grad_norm": []}
    for _ in range(sp["steps"]):
        state, m = step(state, x, y, 0)
        for k in metrics:
            metrics[k].append(float(m[k]))
    final = flatten_tree(variables_from_torch_state_dict(
        state.model.state_dict()))
    return {k: np.array(v) for k, v in metrics.items()}, final


def gaps(golden, case, metrics, final):
    """(loss, grad_norm, params, stats) gaps of a port run to the golden."""
    def rel(k):
        return np.abs(metrics[k] - golden[f"{case}/{k}"]).max() / \
            np.abs(golden[f"{case}/{k}"]).max()
    want = {k: golden[f"{case}/final/{k}"] for k in final}
    params = [k for k in final if k.startswith("params/")]
    scale = max(np.abs(want[k]).max() for k in params)
    p_gap = max(np.abs(final[k] - want[k]).max() for k in params) / scale
    s_gap = max(np.abs(final[k] - want[k]).max() / np.abs(want[k]).max()
                for k in final if k.startswith("batch_stats/"))
    return rel("loss"), rel("grad_norm"), p_gap, s_gap


def within(gap, gate):
    return all(g <= t for g, t in zip(gap, gate))


@pytest.mark.parametrize("case", sorted(GATES))
def test_golden_case(golden, case):
    metrics, final = run_case(golden, case)
    assert set(final) == {k[len(case) + 7:] for k in golden
                          if k.startswith(f"{case}/final/")}
    np.testing.assert_array_equal(metrics["accuracy"],
                                  golden[f"{case}/accuracy"])
    gap = gaps(golden, case, metrics, final)
    assert within(gap, GATES[case]), (gap, GATES[case])


@pytest.mark.parametrize("control", ["decay_all", "momentum"])
def test_golden_gate_fails_controls(golden, control):
    kwargs = ({"decay_all": True} if control == "decay_all"
              else {"momentum": 0.9})
    metrics, final = run_case(golden, "a", **kwargs)
    assert not within(gaps(golden, "a", metrics, final), GATES["a"])


def test_train_golden_is_current(golden):
    """JAX makes the golden's init, batch and case a again."""
    from tests.torch_port_goldens import (jax_train_case, jax_train_init,
                                          train_batch)
    init = jax_train_init()
    flat = flatten_tree(init)
    assert set(flat) == {k[5:] for k in golden if k.startswith("init/")}
    for k, v in flat.items():
        np.testing.assert_array_equal(v, golden[f"init/{k}"])
    images, labels = train_batch()
    np.testing.assert_array_equal(images, golden["images"])
    np.testing.assert_array_equal(labels, golden["labels"])
    res = jax_train_case("a", init, images, labels)
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(res[k], golden[f"a/{k}"], rtol=1e-6)
    for k, v in flatten_tree(res["final"]).items():
        np.testing.assert_allclose(v, golden[f"a/final/{k}"], rtol=1e-5,
                                   atol=1e-7)


def _trainer(golden, accum=1):
    model = _model(golden)
    tx = make_optimizer("sgd", 0.05, grad_clip=1.0)
    return Trainer(model, tx, make_classification_loss("label_smoothing"),
                   policy=FP32_POLICY, grad_accum_steps=accum)


def test_eval_step_masks_and_counts_as_jax(golden):
    import jax
    import jax.numpy as jnp
    from rtdm_tpu.core.precision import FP32_POLICY as JAX_FP32
    from rtdm_tpu.models import create_model as jax_create_model
    from rtdm_tpu.train.losses import make_classification_loss as jax_loss
    from rtdm_tpu.train.trainer import TrainState, make_eval_step

    x = normalize_batch(torch.from_numpy(golden["images"][:8]))
    y = golden["labels"][:8].copy()
    y[6:] = 0       # padding rows carry label 0, as the loader's do
    jax_step = make_eval_step(
        jax_create_model("squeeze-ernet", dropout_rate=0.0), JAX_FP32,
        jax_loss("label_smoothing"))
    jstate = TrainState(step=jnp.zeros((), jnp.int32),
                        params=golden["init"]["params"],
                        batch_stats=golden["init"]["batch_stats"],
                        opt_state=None)
    trainer = _trainer(golden)
    state = trainer.init_state()
    for valid in (8, 5, 1):
        want = jax.device_get(jax_step(jstate, jnp.asarray(x.numpy()),
                                       jnp.asarray(y), jnp.int32(valid)))
        got = trainer.eval_step(state, x, torch.from_numpy(y).long(), valid)
        np.testing.assert_array_equal(got["confusion"].numpy(),
                                      want["confusion"])
        assert int(got["correct"]) == int(want["correct"])
        assert int(got["count"]) == int(want["count"]) == valid
        assert int(got["confusion"].sum()) == valid
        np.testing.assert_allclose(float(got["loss_sum"]),
                                   float(want["loss_sum"]), rtol=1e-5)


def test_eval_after_a_step_sees_the_new_weights(golden):
    """ROADMAP fault 4: the eval's kernel arguments follow the weights."""
    trainer = _trainer(golden)
    state = trainer.init_state()
    x = normalize_batch(torch.from_numpy(golden["images"]))
    y = torch.from_numpy(golden["labels"]).long()
    model = trainer.eval_step.model

    def logits():
        with torch.no_grad():
            return model(x[:4], apply_softmax=False)

    trainer.eval_step(state, x[:4], y[:4], 4)
    first = logits()
    state, _ = trainer.train_step(state, x, y, 0)
    trainer.eval_step(state, x[:4], y[:4], 4)
    second = logits()
    fresh = create_model("squeeze-ernet", device="cpu").eval()
    fresh.load_state_dict(state.model.state_dict())
    with torch.no_grad(), layer_by_layer(fresh):
        want = fresh(x[:4], apply_softmax=False)
    torch.testing.assert_close(second, want, rtol=1e-5, atol=1e-5)
    assert (second - first).abs().max() > 1e-3


def test_acff_arguments_follow_an_in_place_change():
    block = ACFF(8, 64, 0.0).eval()
    x = torch.randn(2, 10, 10, 8, generator=torch.Generator().manual_seed(0))
    before = block(x)
    with torch.no_grad():
        block.fused_conv.weight.mul_(2.0)
    block.train()
    block.eval()
    after = block(x)
    torch.testing.assert_close(after, block.forward_layers(x), rtol=1e-5,
                               atol=1e-5)
    assert (after - before).abs().max() > 1e-3
    block.fused_conv.weight.data.mul_(0.5)
    block.clear_packed()
    torch.testing.assert_close(block(x), before, rtol=0, atol=0)


def test_checkpoint_round_trip_and_resume(golden, tmp_path):
    x = normalize_batch(torch.from_numpy(golden["images"]))
    y = torch.from_numpy(golden["labels"]).long()
    trainer = _trainer(golden, accum=2)
    state = trainer.init_state()
    state, _ = trainer.train_step(state, x, y, 3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save("last", state, {"epoch": 0, "history": {"val_loss": [1.0]}})
    assert mgr.exists("last") and not mgr.exists("best")
    state, _ = trainer.train_step(state, x, y, 3)   # uninterrupted run
    want = {k: v.clone() for k, v in state.model.state_dict().items()}

    other = _trainer(golden, accum=2)
    resumed = other.init_state()
    resumed, meta = mgr.restore("last", resumed)
    assert meta["epoch"] == 0 and meta["history"]["val_loss"] == [1.0]
    assert resumed.step == 1
    resumed, _ = other.train_step(resumed, x, y, 3)
    got = resumed.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert resumed.step == state.step == 2
    m1 = other.eval_step(resumed, x[:4], y[:4], 4)
    m2 = trainer.eval_step(state, x[:4], y[:4], 4)
    assert torch.equal(m1["confusion"], m2["confusion"])
