"""The port's training layers against the JAX package: BatchNorm in
training mode (output, batch statistics, running statistics) in fp32 and
bf16 against the jitted ``rtdm_tpu.models.layers.BatchNorm(train=True)``,
the ACFF block's and Squeeze_ErNET's training forwards (dropout 0) and their
gradients against ``jax.value_and_grad`` of the JAX modules, and dropout's
keep rate and scale.

Tolerances, each with a control that fails it:
- BatchNorm fp32: output within 1e-5 of max |out|, running statistics
  within 1e-6 relative; bf16: output within one bf16 rounding (2^-8 of
  max |out|). Control: torch's own ``batch_norm`` statistics (two-pass
  variance) on a probe whose E[x²] - E[x]² rounds off (values 64 + k/8, 64
  rows a channel, so every sum is exact in either order) miss the gate.
- ACFF block: output and gradients within 5e-5 of each one's max.
- Squeeze_ErNET: loss within 1e-5 relative; each gradient leaf's mean
  |difference| within 2e-4 of its mean |value| (read: 2.5e-5; the
  control 39). Not its largest: the
  forward differs from XLA's by ulps, and where two values of a 2x2
  max-pool window tie within them the two frameworks send the gradient to
  different pixels (the float64 port differs from JAX as much there).
  Control: BatchNorm with the running statistics in training misses it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtdm_tpu.models import create_model as jax_create_model
from rtdm_tpu.models.acff import ACFF as JaxACFF
from rtdm_tpu.models.layers import BatchNorm as JaxBatchNorm
from rtdm_tpu.train.losses import make_classification_loss as jax_loss
from rtdm_tpu_torch.models import create_model
from rtdm_tpu_torch.models.acff import ACFF
from rtdm_tpu_torch.models.io import (flatten_tree,
                                      torch_state_dict_from_variables,
                                      variables_from_torch_state_dict)
from rtdm_tpu_torch.models.layers import (BatchNorm, DepthwiseConv, Dropout,
                                          set_dropout_generator)
from rtdm_tpu_torch.train.losses import make_classification_loss

BN_TOL = 1e-5
ACFF_TOL = 5e-5
GRAD_MEAN_TOL = 2e-4


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _jax_bn(x, variables):
    bn = JaxBatchNorm()
    out, mut = jax.jit(lambda v, a: bn.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables, x)
    return np.asarray(out.astype(jnp.float32)), mut["batch_stats"]


def _bn_variables(rng, c):
    return {"params": {"scale": rng.normal(1, 0.2, c).astype(np.float32),
                       "bias": rng.normal(0, 0.2, c).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(0, 1, c).astype(np.float32),
                            "var": rng.uniform(0.5, 2, c).astype(np.float32)}}


def _port_bn(variables, c):
    bn = BatchNorm(c)
    bn.load_state_dict(torch_state_dict_from_variables(variables))
    return bn.train()


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        np.abs(want).max()


def _offset_probe(rng, c=8):
    """64 + k/8 at 4x4x4 positions a channel: every sum of x and x² is exact
    in fp32 in any order, so E[x] and E[x²] are equal in both packages and
    only the variance's formula differs."""
    k = rng.integers(-8, 9, (4, 4, 4, c))
    return (64.0 + k / 8.0).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_matches_jax(rng, dtype):
    c = 8
    x = rng.normal(0.5, 2.0, (4, 5, 5, c)).astype(np.float32)
    variables = _bn_variables(rng, c)
    xj = jnp.asarray(x).astype(dtype)
    want, stats = _jax_bn(xj, variables)
    bn = _port_bn(variables, c)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = bn(xt)
    assert got.dtype == xt.dtype
    tol = BN_TOL if dtype == "float32" else 2.0 ** -8
    assert _rel(got.float().detach().numpy(), want) <= tol
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(stats[key]), rtol=1e-6,
                                   atol=1e-7)


def test_batchnorm_gate_fails_torch_batch_norm(rng):
    """The control: torch's batch_norm (two-pass variance) misses the fp32
    gate on the offset probe, which the port meets."""
    x = _offset_probe(rng)
    variables = _bn_variables(rng, 8)
    want, _ = _jax_bn(jnp.asarray(x), variables)
    bn = _port_bn(variables, 8)
    xt = torch.from_numpy(x)
    assert _rel(bn(xt).detach().numpy(), want) <= BN_TOL
    p = variables["params"]
    torch_out = torch.nn.functional.batch_norm(
        xt.permute(0, 3, 1, 2), None, None, torch.from_numpy(p["scale"]),
        torch.from_numpy(p["bias"]), training=True, eps=1e-5)
    assert _rel(torch_out.permute(0, 2, 3, 1).numpy(), want) > BN_TOL


def test_acff_training_forward_and_gradients_match_jax(rng):
    x = rng.normal(size=(4, 11, 11, 16)).astype(np.float32)
    ct = rng.normal(size=(4, 9, 9, 32)).astype(np.float32)
    jm = JaxACFF(32, 0.0)
    v = jax.device_get(jm.init(jax.random.key(1), jnp.asarray(x)))

    def f(params, a):
        return jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        a, train=True, mutable=["batch_stats"])[0]

    out, vjp = jax.vjp(jax.jit(f), v["params"], jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))
    m = ACFF(16, 32, 0.0)
    m.load_state_dict(torch_state_dict_from_variables(v))
    m.train()
    xt = torch.from_numpy(x).requires_grad_()
    got = m(xt)
    got.backward(torch.from_numpy(ct))
    assert _rel(got.detach().numpy(), np.asarray(out)) <= ACFF_TOL
    assert _rel(xt.grad.numpy(), np.asarray(gx)) <= ACFF_TOL
    grads = flatten_tree(variables_from_torch_state_dict(
        {n: p.grad for n, p in m.named_parameters()})["params"])
    for key, want in flatten_tree(jax.device_get(gp)).items():
        assert _rel(grads[key], np.asarray(want)) <= ACFF_TOL, key


@pytest.fixture(scope="module")
def squeeze_grads():
    """JAX's loss and gradients of Squeeze_ErNET in training mode (dropout
    0) on a seeded batch of 4, with the initial variables."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 140, 140, 3)).astype(np.float32)
    y = rng.integers(0, 5, 4).astype(np.int32)
    jm = jax_create_model("squeeze-ernet", dropout_rate=0.0)
    v = jax.device_get(jm.init(jax.random.key(2), jnp.asarray(x[:1])))
    lf = jax_loss("label_smoothing")

    def loss_of(params):
        logits, _ = jm.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), train=True, apply_softmax=False,
                             mutable=["batch_stats"])
        return lf(logits.astype(jnp.float32), jnp.asarray(y))

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(v["params"])
    return x, y, v, float(loss), flatten_tree(jax.device_get(grads))


def _port_loss_and_grads(x, y, variables, bn_train=True):
    m = create_model("squeeze-ernet", device="cpu", dropout_rate=0.0)
    m.load_state_dict(torch_state_dict_from_variables(variables))
    m.train()
    if not bn_train:
        for mod in m.modules():
            if isinstance(mod, BatchNorm):
                mod.eval()
    logits = m(torch.from_numpy(x))
    loss = make_classification_loss("label_smoothing")(
        logits.float(), torch.from_numpy(y).long())
    loss.backward()
    grads = flatten_tree(variables_from_torch_state_dict(
        {n: p.grad for n, p in m.named_parameters()})["params"])
    return float(loss.detach()), grads


def _worst_mean_gap(grads, want):
    return max(np.abs(grads[k] - w).mean() / np.abs(w).mean()
               for k, w in want.items())


def test_squeeze_ernet_training_gradients_match_jax(squeeze_grads):
    x, y, v, loss, want = squeeze_grads
    got_loss, grads = _port_loss_and_grads(x, y, v)
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    assert set(grads) == set(want)
    assert _worst_mean_gap(grads, want) <= GRAD_MEAN_TOL


def test_squeeze_ernet_gradient_gate_fails_running_stat_bn(squeeze_grads):
    x, y, v, _, want = squeeze_grads
    _, grads = _port_loss_and_grads(x, y, v, bn_train=False)
    assert _worst_mean_gap(grads, want) > GRAD_MEAN_TOL


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_bf16_depthwise_gradients_on_the_cpu(dilation):
    """A bf16 DepthwiseConv's gradients on the CPU (an fp32 conv of the
    bf16 values: oneDNN's bf16 depthwise weight gradient is wrong at
    dilation 2 and 3) within 2^-7 of each one's max of float64's."""
    gen = torch.Generator().manual_seed(dilation)
    x = torch.randn(8, 33, 33, 64, generator=gen)
    ct = torch.randn(8, 31, 31, 64, generator=gen)
    grads = {}
    for dtype in (torch.bfloat16, torch.float64):
        conv = DepthwiseConv(64, 3, padding=dilation - 1, dilation=dilation)
        conv.weight.data = torch.randn(64, 1, 3, 3, generator=torch.Generator(
        ).manual_seed(0)).to(dtype)
        conv.bias.data = conv.bias.data.to(dtype)
        xx = x.to(dtype).requires_grad_()
        conv(xx).backward(ct.to(dtype))
        grads[dtype] = (xx.grad.double(), conv.weight.grad.double(),
                        conv.bias.grad.double())
    for got, want in zip(grads[torch.bfloat16], grads[torch.float64]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2.0 ** -7 * want.abs().max()


def test_training_forward_returns_logits():
    m = create_model("squeeze-ernet", device="cpu", dropout_rate=0.0)
    x = torch.zeros((2, 140, 140, 3))
    assert torch.allclose(m(x).sum(-1), torch.ones(2))    # softmax
    logits = m.train()(x)
    assert not torch.allclose(logits.sum(-1), torch.ones(2))


def test_dropout_keep_rate_and_scale():
    drop = Dropout(0.3).train()
    x = torch.ones(200_000)
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 5e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.7))
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)                       # seeded
    assert torch.equal(drop.eval()(x), x)                # inference
    assert torch.equal(Dropout(0.0).train()(x), x)       # rate 0
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.5).train()(x)


def test_model_dropout_draws_from_its_generator():
    m = create_model("squeeze-ernet", device="cpu", dropout_rate=0.5).train()
    x = torch.randn(2, 140, 140, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for seed in (3, 3, 4):
        set_dropout_generator(m, torch.Generator().manual_seed(seed))
        outs.append(m(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_create_model_init_follows_its_generator():
    def weights(seed):
        return create_model("squeeze-ernet", device="cpu",
                            generator=torch.Generator().manual_seed(seed)
                            ).state_dict()
    a, b, c = weights(7), weights(7), weights(8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["acff1.fused_conv.weight"],
                           c["acff1.fused_conv.weight"])
    w = a["acff2.fused_conv.weight"]          # fan_in 3 * 64
    std = np.sqrt(2.0 / w[0].numel())
    assert abs(w.std().item() / std - 1) < 0.05
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
