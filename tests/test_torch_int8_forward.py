"""The true-int8 classifier forward (``quant/int8.py``:
``_prep_int8_kernel``, ``int8_pointwise``, ``int8_classifier_forward``)
against the jitted JAX functions.

``_prep_int8_kernel`` bit-equal. ``int8_pointwise``: on the same inputs
the int8 codes and the int32 accumulators bit-equal (exact in any order
once the codes match) and the fp32 output within 1 ulp (XLA:CPU may or
may not contract the dequantize and the bias add into one FMA). The
forward on each committed ``*_int8`` engine's params and ``act_scales``
within 3e-2 of max |prob| (the port's int8 gate) with equal argmax, at
batch 16 and again at 4 (JAX's retrace case), and Squeeze_ErNET at batch
1, whose acff4 product has 16 rows (``torch._int_mm`` takes more: the
rows are padded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdm_tpu_torch.data.aider import normalize_batch
from rtdm_tpu_torch.models import create_model
from rtdm_tpu_torch.quant.int8 import (INT_MM, _prep_int8_kernel,
                                       int8_classifier_forward, int8_matmul,
                                       int8_pointwise, quantize_codes)
from tests.torch_port_goldens import (  # noqa: F401 (two_threads)
    EXAMPLES, GOLDEN, GOLDEN_LAYOUT, MODELS, image_size, int8_engine_tree,
    jax_int8_forward, port_model, two_threads)

INT8_TOL = 3e-2


@pytest.fixture(scope="module")
def frames():
    """The 10 example frames repeated to a batch of 16."""
    with np.load(GOLDEN) as g:
        return {s: np.resize(g[f"frames_{s}"], (16, s, s, 3))
                for s in (140, 240)}


@pytest.fixture(scope="module")
def engines():
    return {model: int8_engine_tree(model) for model in MODELS}


@pytest.fixture(scope="module")
def jax_forward():
    """The jitted JAX true-int8 forward of each engine, u8 -> probs."""
    return {model: jax_int8_forward(model) for model in MODELS}


def test_prep_int8_kernel_matches_jax(engines):
    from rtdm_tpu.quant.int8 import _prep_int8_kernel as jax_prep
    rng = np.random.default_rng(0)
    kernels = [rng.normal(size=(1, 1, 48, 64)).astype(np.float32),
               np.zeros((1, 1, 24, 8), np.float32)]
    for variables, _ in engines.values():
        kernels += [v["fused_conv"]["kernel"]
                    for k, v in variables["params"].items()
                    if k.startswith("acff")]
    for kernel in kernels:
        for got, want in zip(_prep_int8_kernel(kernel), jax_prep(kernel)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 5, 5, 48), (1, 4, 4, 384),
                                   (3, 7, 3, 288)])
def test_int8_pointwise_matches_jax(shape):
    """Codes and int32 accumulators bit-equal, the output within 1 ulp; the
    (1, 4, 4, 384) case is Squeeze_ErNET's acff4 at batch 1 (16 rows)."""
    from rtdm_tpu.quant.int8 import int8_pointwise as jax_pointwise
    rng = np.random.default_rng(sum(shape))
    c, o = shape[-1], 64
    x = rng.normal(scale=2.0, size=shape).astype(np.float32)
    kq, ks = _prep_int8_kernel(rng.normal(size=(1, 1, c, o)).astype(
        np.float32))
    bias = rng.normal(size=o).astype(np.float32)
    act_scale = float(np.float32(np.abs(x).max() / 127 * 0.8))
    want_q = np.asarray(jax.jit(lambda t: jnp.clip(
        jnp.round(t / act_scale), -127, 127).astype(jnp.int8))(x))
    got_q = quantize_codes(torch.from_numpy(x), act_scale).numpy()
    np.testing.assert_array_equal(got_q, want_q)
    want_acc = np.asarray(jax.jit(lambda q, k: jnp.dot(
        q, k, preferred_element_type=jnp.int32))(want_q.reshape(-1, c), kq))
    before = dict(INT_MM)
    got_acc = int8_matmul(torch.from_numpy(got_q.reshape(-1, c)),
                          torch.from_numpy(kq)).numpy()
    assert got_acc.dtype == np.int32
    np.testing.assert_array_equal(got_acc, want_acc)
    rows = want_acc.shape[0]
    assert INT_MM["padded_calls"] - before["padded_calls"] == (rows <= 16)
    want = np.asarray(jax.jit(lambda t, k, s, b: jax_pointwise(
        t, k, s, b, act_scale))(x, kq, ks, bias))
    got = int8_pointwise(torch.from_numpy(x), torch.from_numpy(kq),
                         torch.from_numpy(ks), torch.from_numpy(bias),
                         act_scale).numpy()
    assert got.shape == want.shape == shape[:3] + (o,)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def _port_probs(model, engines, u8):
    variables, scales = engines[model]
    fwd = int8_classifier_forward(
        port_model(model, variables, "fp32", split_fuse=False), scales)
    return fwd(normalize_batch(torch.from_numpy(u8))).numpy()


def _hold(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=INT8_TOL * np.abs(want).max())


@pytest.mark.parametrize("model", MODELS)
def test_int8_classifier_forward_matches_jax(frames, engines, jax_forward,
                                             model):
    u8 = frames[image_size(model)]
    for batch in (16, 4):
        want = np.asarray(jax_forward[model](jnp.asarray(u8[:batch])))
        got = _port_probs(model, engines, u8[:batch])
        assert got.shape == (batch, 5)
        _hold(got, want)
        np.testing.assert_allclose(got.sum(1), np.ones(batch), rtol=1e-5)


def test_int8_forward_batch_one_pads_the_16_row_product(frames, engines,
                                                        jax_forward):
    u8 = frames[140][:1]
    before = dict(INT_MM)
    got = _port_probs("squeeze-ernet", engines, u8)
    assert INT_MM["calls"] - before["calls"] == 4
    assert INT_MM["padded_calls"] - before["padded_calls"] == 1
    assert INT_MM["rows_added"] - before["rows_added"] == 8
    _hold(got, np.asarray(jax_forward["squeeze-ernet"](jnp.asarray(u8))))


def test_int8_forward_refusals(engines):
    with pytest.raises(TypeError, match="unsupported"):
        int8_classifier_forward(torch.nn.Linear(2, 2), engines["ernet"][1])
    fwd = int8_classifier_forward(create_model("squeeze-ernet",
                                               device="cpu"),
                                  engines["squeeze-ernet"][1])
    x = torch.zeros((1, 140, 140, 3), device="meta")
    with pytest.raises(ValueError, match="the model on cpu"):
        fwd(x)


def test_layout_golden_int8_is_current(frames, jax_forward):
    """The golden's true-int8 probabilities on the 10 example frames equal a
    fresh JAX run (within 1e-6)."""
    with np.load(GOLDEN_LAYOUT) as g:
        golden = dict(g)
    n = len(EXAMPLES)
    for model in MODELS:
        want = np.asarray(jax_forward[model](
            jnp.asarray(frames[image_size(model)][:n])))
        np.testing.assert_allclose(golden[f"int8_{model}"], want, rtol=0,
                                   atol=1e-6)
