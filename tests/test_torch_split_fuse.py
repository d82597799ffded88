"""``split_fuse`` (the ACFF block's concat-free 1x1 fuse) on the three
classifiers with the committed weights, against the jitted JAX
``create_model(name, split_fuse=True)`` on the 10 example frames.

Eval (the fused block, as every eval of the port): fp32, the
probabilities at JAX's own bound for split against concat (rtol 1e-5, atol
1e-6, ``tests/test_classifier_models.py``) and the logits within 1e-5 of
max |logit|; bf16, the logits within 2e-2 of max |logit|; argmax equal in
both. ``layer_by_layer`` runs the split route itself, at the same logit
bounds. Its bf16 logits are not bit-equal to JAX's: XLA:CPU sums the convs
in another order, and a bf16 rounding then differs (measured 3.2e-3 to
9.6e-3 of max |logit|, as far as the unsplit route, and JAX's own bf16
logits lie 3.0e-3 to 1.2e-2 from the float64 ones). Its fp32
probabilities are held by the softmax's own bound, half the largest logit
change (the logits differ by at most 2.4e-7 of max |logit|): on one
Squeeze_RedConv frame near a tie they differ by 3.2e-6, where JAX's own
unsplit fp32 probabilities lie 3.4e-6 from the float64 ones.

Training (batch statistics, dropout 0), both sides on the same normalized
input: the logits and the gradient of every ``fused_conv.weight`` against
``jax.grad``. The float64 witness is JAX itself in float64: the port's
float64 gradient, split and unsplit, within 1e-12 of max |grad| of it
(measured at most 5.4e-14). JAX's fp32 gradient is 1.2e-6 to 5.0e-5 of
max |grad| from its float64 one, so the port's fp32 gradient is held
within 1e-5 of max |grad| of JAX's or, where JAX is farther than that from
float64, within twice JAX's distance (measured 1.3e-6 to 4.0e-5), and
within 2e-5 of the float64 witness (measured at most 1.25e-5). The split
model's eval output equals the unsplit model's bit for bit: same op, same
weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdm_tpu_torch.data.aider import normalize_batch
from rtdm_tpu_torch.models import create_model
from rtdm_tpu_torch.models.acff import ACFF, layer_by_layer
from rtdm_tpu_torch.models.io import load_variables
from tests.torch_port_goldens import (  # noqa: F401 (two_threads)
    GOLDEN, GOLDEN_LAYOUT, EXAMPLES, MODELS, image_size, jax_split_logits,
    params_path, port_model, two_threads)

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
GRAD_BATCH = 2
FUSED_BATCH = 2


@pytest.fixture(scope="module")
def frames():
    with np.load(GOLDEN) as g:
        return {s: g[f"frames_{s}"] for s in (140, 240)}


@pytest.fixture(scope="module")
def variables():
    return {m: load_variables(params_path(m)) for m in MODELS}


@pytest.fixture(scope="module")
def jax_eval(frames, variables):
    """JAX split-fuse logits by (model, quant), jitted, computed once."""
    cache = {}

    def get(model, quant):
        if (model, quant) not in cache:
            cache[model, quant] = jax_split_logits(
                model, quant, variables[model], frames[image_size(model)])
        return cache[model, quant]
    return get


def _port_logits(net, quant, frames_u8):
    x = normalize_batch(torch.from_numpy(frames_u8)).to(DTYPES[quant][0])
    with torch.no_grad():
        return net(x, apply_softmax=False).float().numpy()


def _softmax(z):
    e = np.exp(z - z.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


def _hold(got, want, quant):
    """fp32: the probabilities at JAX's bound, the logits within 1e-5 of
    max |logit|; bf16: the logits within 2e-2 of it; argmax equal."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    rel = {"fp32": 1e-5, "bf16": 2e-2}[quant]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())
    if quant == "fp32":
        np.testing.assert_allclose(_softmax(got.astype(np.float64)),
                                   _softmax(want.astype(np.float64)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quant", ["fp32", "bf16"])
@pytest.mark.parametrize("model", MODELS)
def test_split_fuse_eval_matches_jax(frames, variables, jax_eval, model,
                                     quant):
    net = port_model(model, variables[model], quant)
    got = _port_logits(net, quant, frames[image_size(model)])
    _hold(got, jax_eval(model, quant), quant)


@pytest.mark.parametrize("quant", ["fp32", "bf16"])
@pytest.mark.parametrize("model", MODELS)
def test_split_fuse_layer_by_layer_matches_jax(frames, variables, jax_eval,
                                               model, quant):
    net = port_model(model, variables[model], quant)
    with layer_by_layer(net):
        got = _port_logits(net, quant, frames[image_size(model)])
    want = jax_eval(model, quant)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    rel = {"fp32": 1e-5, "bf16": 2e-2}[quant]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())
    if quant == "fp32":
        dz = np.abs(got - want).max(1, keepdims=True)
        dp = np.abs(_softmax(got.astype(np.float64))
                    - _softmax(want.astype(np.float64)))
        assert np.all(dp <= 0.5 * dz + 1e-6), (dp.max(), dz.max())


@pytest.mark.parametrize("model", MODELS)
def test_split_eval_equals_unsplit(frames, variables, model):
    x = frames[image_size(model)]
    for quant in DTYPES:
        split = _port_logits(port_model(model, variables[model], quant),
                             quant, x)
        whole = _port_logits(port_model(model, variables[model], quant,
                                        split_fuse=False), quant, x)
        np.testing.assert_array_equal(split, whole)


def test_checkpoints_load_with_no_key_change(variables):
    """The split model's state dict has the unsplit one's keys and shapes,
    so a checkpoint of either loads strictly into the other."""
    split = create_model("squeeze-ernet", device="cpu", split_fuse=True)
    whole = create_model("squeeze-ernet", device="cpu")
    assert {k: v.shape for k, v in split.state_dict().items()} == \
        {k: v.shape for k, v in whole.state_dict().items()}
    split.load_state_dict(whole.state_dict(), strict=True)
    assert all(m.split_fuse for m in split.modules() if isinstance(m, ACFF))
    assert not any(m.split_fuse for m in whole.modules()
                   if isinstance(m, ACFF))


def _port_train_grads(model, variables, u8, r, dtype, split_fuse=True):
    """The port's training-mode logits and each ACFF block's
    ``fused_conv.weight`` gradient of sum(logits * r), in ``dtype``."""
    port = port_model(model, variables, split_fuse=split_fuse).train()
    port = port.to(dtype)
    for m in port.modules():
        if isinstance(m, ACFF):
            m.dropout.rate = 0.0
    logits = port(normalize_batch(torch.from_numpy(u8)).to(dtype))
    (logits * torch.from_numpy(r).to(dtype)).sum().backward()
    grads = {n: m.fused_conv.weight.grad.double().numpy()
             for n, m in port.named_modules() if isinstance(m, ACFF)}
    return logits.detach().double().numpy(), grads


class _Float64Names:
    """``jax.numpy`` with ``float32`` naming float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_train_grads(model, x, r, dtype):
    """JAX's jitted training-mode logits and each ACFF block's
    ``fused_conv`` kernel gradient (as OIHW float64) of sum(logits * r),
    weights and input in ``dtype``."""
    from rtdm_tpu.models import create_model as jax_create
    net = jax_create(model, split_fuse=True, dropout_rate=0.0)
    v = jax.tree.map(lambda a: np.asarray(a, dtype),
                     load_variables(params_path(model)))

    def loss(params, x):
        logits, _ = net.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(logits * r.astype(dtype)), logits
    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"], jnp.asarray(x.astype(dtype)))
    return np.asarray(logits, np.float64), {
        n: np.asarray(g["fused_conv"]["kernel"], np.float64).transpose(
            3, 2, 0, 1) for n, g in grads.items() if "fused_conv" in g}


@pytest.mark.parametrize("model", MODELS)
def test_split_fuse_train_gradient_matches_jax(frames, model, monkeypatch):
    """Training mode (batch statistics, dropout 0): the logits and the
    gradient of every ACFF ``fused_conv`` kernel of sum(logits * r). The
    float64 witness is JAX itself with x64 on and its ``layers.py``
    computing BatchNorm and ACON in float64 (they cast to fp32 by design;
    the test points that module's ``jnp.float32`` at float64 for the one
    run, the file is unchanged)."""
    import rtdm_tpu.models.layers as jax_layers
    u8 = frames[image_size(model)][:GRAD_BATCH]
    r = np.random.default_rng(0).normal(size=(GRAD_BATCH, 5)).astype(
        np.float32)
    x = normalize_batch(torch.from_numpy(u8)).numpy()
    want_logits, want = _jax_train_grads(model, x, r, np.float32)
    with monkeypatch.context() as m, jax.enable_x64(True):
        m.setattr(jax_layers, "jnp", _Float64Names())
        _, want64 = _jax_train_grads(model, x, r, np.float64)

    # fresh trees: a port model loaded with assign=True shares their
    # memory, and its BatchNorm updates the running statistics in training
    logits, got = _port_train_grads(model, load_variables(
        params_path(model)), u8, r, torch.float32)
    _, ref = _port_train_grads(model, load_variables(params_path(model)),
                               u8, r, torch.float64)
    _, whole = _port_train_grads(model, load_variables(params_path(model)),
                                 u8, r, torch.float64, split_fuse=False)
    np.testing.assert_allclose(logits, want_logits, rtol=0,
                               atol=1e-5 * np.abs(want_logits).max())
    assert len(got) == len(want) == (6 if model == "ernet" else 4)
    for name in got:
        scale = np.abs(want64[name]).max()
        np.testing.assert_allclose(ref[name], want64[name], rtol=0,
                                   atol=1e-12 * scale, err_msg=name)
        np.testing.assert_allclose(whole[name], want64[name], rtol=0,
                                   atol=1e-12 * scale, err_msg=name)
        jax_noise = np.abs(want[name] - want64[name]).max() / scale
        gate = max(1e-5, 2 * jax_noise)
        assert np.abs(got[name] - want[name]).max() <= gate * scale, name
        assert np.abs(got[name] - want64[name]).max() <= 2e-5 * scale, name


@pytest.mark.parametrize("model", MODELS)
def test_fused_classifier_forward(frames, variables, model):
    """``ops/acff.py::fused_classifier_forward``: on the CPU its
    probabilities are ``softmax(model(x))`` bit for bit in fp32 and bf16,
    and in fp32 within 1e-5 of max |prob| of the JAX function run in
    Pallas interpret mode."""
    from rtdm_tpu.models import create_model as jax_create
    from rtdm_tpu.ops.acff_pallas import fused_classifier_forward as jax_fcf
    from rtdm_tpu_torch.ops.acff import fused_classifier_forward
    u8 = frames[image_size(model)][:FUSED_BATCH]
    x = normalize_batch(torch.from_numpy(u8))
    for quant in DTYPES:
        net = port_model(model, variables[model], quant, split_fuse=False)
        got = fused_classifier_forward(net)(x)
        with torch.no_grad():
            want = net(x.to(DTYPES[quant][0])).float()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if quant == "fp32":
            fp32 = got.numpy()
    fwd = jax_fcf(jax_create(model), variables[model], interpret=True)
    want = np.asarray(jax.jit(fwd)(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(fp32.argmax(1), want.argmax(1))
    np.testing.assert_allclose(fp32, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(TypeError, match="unsupported"):
        fused_classifier_forward(torch.nn.Linear(2, 2))
    with layer_by_layer(net), pytest.raises(RuntimeError, match="fused"):
        fused_classifier_forward(net)(x)


def test_layout_golden_split_is_current(jax_eval):
    """The golden's split-fuse logits (``chip_smoke.py`` phase 14 holds the
    card to them) equal a fresh JAX run (1e-5 of max |logit|, as the
    engine goldens: XLA:CPU may split sums differently across threads)."""
    with np.load(GOLDEN_LAYOUT) as g:
        golden = dict(g)
    assert list(golden["names"]) == [p.name for p in EXAMPLES]
    for model in MODELS:
        for quant in DTYPES:
            want = jax_eval(model, quant)
            np.testing.assert_allclose(golden[f"split_{model}_{quant}"],
                                       want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
