"""Batch-in-channels packed inference (``models/packed.py``) against the
jitted JAX ``packed_forward`` on the committed weights: Squeeze_ErNET at
140 and ErNET at 240, pack factors 2 and 8, both layouts, on the first 8
example frames (distinct images, so a permuted image or channel group
shows).

fp32: atol 1e-6, rtol 1e-5 on the probabilities, the JAX package's own
bound for packed against the standard forward (``tests/test_packed.py``),
and the port's packed forward against its own classifier's eval at that
bound too. bf16: equal argmax and max |dprob| <= 2e-2. ``pack_images`` and
``_block_diag_kernel`` (both input orders) bit-equal to JAX's; the refusals
of Squeeze_RedConv and of a batch the pack factor does not divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdm_tpu_torch.data.aider import normalize_batch
from rtdm_tpu_torch.models.io import (load_variables,
                                      torch_state_dict_from_variables)
from rtdm_tpu_torch.models.packed import (_block_diag_kernel, pack_images,
                                          packed_engine_fn, packed_forward)
from tests.torch_port_goldens import (  # noqa: F401 (two_threads)
    GOLDEN, GOLDEN_LAYOUT, LAYOUT_K, LAYOUTS, PACKED_MODELS, image_size,
    jax_packed_probs, params_path, port_model, two_threads)

BATCH = LAYOUT_K
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def frames():
    with np.load(GOLDEN) as g:
        return {s: g[f"frames_{s}"][:BATCH] for s in (140, 240)}


@pytest.fixture(scope="module")
def variables():
    return {m: load_variables(params_path(m)) for m in PACKED_MODELS}


@pytest.fixture(scope="module")
def jax_packed(frames, variables):
    """JAX packed probabilities by (model, k, layout, quant), jitted."""
    cache = {}

    def get(model, k, layout, quant):
        key = (model, k, layout, quant)
        if key not in cache:
            cache[key] = jax_packed_probs(model, k, layout, quant,
                                          variables[model],
                                          frames[image_size(model)])
        return cache[key]
    return get


@pytest.mark.parametrize("quant", ["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["grouped", "dense"])
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("model", PACKED_MODELS)
def test_packed_matches_jax(frames, variables, jax_packed, model, k, layout,
                            quant):
    state = torch_state_dict_from_variables(variables[model])
    u8 = torch.from_numpy(frames[image_size(model)])
    got = packed_forward(state, u8, k=k, model=model, layout=layout,
                         compute_dtype=DTYPES[quant][0]).numpy()
    want = jax_packed(model, k, layout, quant)
    assert got.shape == want.shape == (BATCH, 5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    if quant == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-2


@pytest.mark.parametrize("layout", ["grouped", "dense"])
@pytest.mark.parametrize("model", PACKED_MODELS)
def test_packed_equals_the_model_per_image(frames, variables, model, layout):
    """fp32: the packed forward is the classifier's eval image by image."""
    state = torch_state_dict_from_variables(variables[model])
    u8 = torch.from_numpy(frames[image_size(model)])
    fn = packed_engine_fn(state, k=8, model=model, layout=layout,
                          compute_dtype=torch.float32, device="cpu")
    got = fn(u8).numpy()
    net = port_model(model, variables[model], "fp32", split_fuse=False)
    with torch.no_grad():
        want = net(normalize_batch(u8)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_pack_images_matches_jax():
    from rtdm_tpu.models.packed import pack_images as jax_pack
    x = np.random.default_rng(0).normal(size=(8, 3, 5, 4)).astype(np.float32)
    for k in (2, 4, 8):
        want = np.asarray(jax.jit(jax_pack, static_argnums=1)(
            jnp.asarray(x), k))
        got = pack_images(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)
    p = pack_images(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(p[1, :, :, 4:].numpy(), x[3])


@pytest.mark.parametrize("in_order", ["kc", "ck"])
def test_block_diag_kernel_matches_jax(in_order):
    from rtdm_tpu.models.packed import _block_diag_kernel as jax_block_diag
    w = np.random.default_rng(1).normal(size=(3, 3, 5, 7)).astype(
        np.float32)                                   # HWIO
    for k in (2, 8):
        want = np.asarray(jax.jit(jax_block_diag, static_argnums=(1, 2))(
            jnp.asarray(w), k, in_order)).transpose(3, 2, 0, 1)
        got = _block_diag_kernel(
            torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), k,
            in_order).numpy()
        np.testing.assert_array_equal(got, want)


def test_packed_refusals(variables):
    state = torch_state_dict_from_variables(variables["squeeze-ernet"])
    u8 = torch.zeros((4, 140, 140, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="redconv"):
        packed_forward(state, u8, k=2, model="squeeze-redconv")
    with pytest.raises(ValueError, match="redconv"):
        packed_engine_fn(state, k=2, model="squeeze-redconv", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        packed_forward(state, u8[:3], k=2)
    with pytest.raises(ValueError, match="not divisible"):
        pack_images(torch.zeros((6, 2, 2, 3)), 4)
    with pytest.raises(ValueError, match="layout"):
        packed_forward(state, u8, k=2, layout="diagonal")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            packed_engine_fn(state, k=2)


def test_layout_golden_packed_is_current(jax_packed):
    """The golden's packed probabilities (k = 8, the first 8 frames) equal
    a fresh JAX run: fp32 within 1e-6, bf16 within 1e-3."""
    with np.load(GOLDEN_LAYOUT) as g:
        golden = dict(g)
    for model in PACKED_MODELS:
        for layout in LAYOUTS:
            for quant in DTYPES:
                want = jax_packed(model, LAYOUT_K, layout, quant)
                np.testing.assert_allclose(
                    golden[f"packed_{model}_{layout}_{quant}"], want,
                    rtol=0, atol={"fp32": 1e-6, "bf16": 1e-3}[quant])
