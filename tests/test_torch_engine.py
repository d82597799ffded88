"""The port's classifier engine on the CPU against the JAX engine, on the
10 example JPEGs with the committed weights.

Tolerances are relative to max |logit|, because with real weights the
softmax is saturated and probabilities alone prove little. fp32: 1e-4, for
summation order only. bf16: 2e-2; JAX's bf16 engine rounds every conv
branch, bias sum and activation to bf16 while the port's ACFF block rounds
its depthwise features and its output, and JAX's own bf16-vs-fp32 drift on
these images reaches 1.2% of max |logit| (the port is within 0.97%).

int8: the committed ``*_int8`` engine directories against the JAX int8
engine's logits (``tests/goldens/torch_port/classifier_int8_logits.npz``):
argmax equal and max |dlogit| <= 3e-2 of max |logit|, below the smallest
top-2 margin of the JAX int8 logits on these frames (2.9%, ErNET). The
port on the CPU is bit-exact. Four rounding steps of the compiled JAX
engine made the difference, each found by comparing the two (measured
before each was matched: 2.7% / 2.4% / 1.0% of max |logit| for
Squeeze_ErNET / Squeeze_RedConv / ErNET with none, 3.0% for
Squeeze_RedConv with the first two only): the fuse conv's epilogue rounded
to bf16 after the product, the bias add and LeakyReLU
(``ops/acff.py::acff_infer_plain``); conv and dense biases added after the
product is rounded; no rounding where the next QDQ reads a layer's output
at once, and QDQ by the reciprocal of the scale, as XLA compiles them
(``models/layers.py``, ``quant/int8.py``); and the head's average pool
summed in bf16 one window position at a time
(``ops/convpool.py::avg_pool2d_sequential``), the step that made it exact.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rtdm_tpu_torch.cli import aider_predict
from rtdm_tpu_torch.cli.aider_predict import load_image_rgb, preprocess
from rtdm_tpu_torch.export.engine import Engine, EngineSpec, build_engine
from rtdm_tpu_torch.models import create_model
from rtdm_tpu_torch.models.io import load_variables
from tests.torch_port_goldens import (EXAMPLES, GOLDEN, GOLDEN_BATCH,
                                      GOLDEN_INT8, MODELS, example_frames,
                                      image_size, int8_dir, jax_int8_logits,
                                      jax_logits, params_path)

REL_TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 3e-2}


@pytest.fixture(scope="module")
def frames():
    return {s: example_frames(s) for s in (140, 240)}


@pytest.fixture(scope="module")
def jax_out(frames):
    """JAX engine logits by (model, quant), computed once per module."""
    cache = {}

    def get(model, quant):
        if (model, quant) not in cache:
            cache[model, quant] = jax_logits(model, quant,
                                             frames[image_size(model)])
        return cache[model, quant]
    return get


def _port_engine(model, quant, with_softmax=False, batch=GOLDEN_BATCH):
    spec = EngineSpec(model, quant, batch, image_size(model),
                      with_softmax=with_softmax)
    return Engine(spec, load_variables(params_path(model)), device="cpu")


def _softmax(z):
    e = np.exp(z - z.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


@pytest.mark.parametrize("quant", ["fp32", "bf16"])
@pytest.mark.parametrize("model", MODELS)
def test_engine_matches_jax(frames, jax_out, model, quant):
    x = frames[image_size(model)]
    want = jax_out(model, quant)
    got = _port_engine(model, quant)(x)
    assert got.shape == want.shape == (len(EXAMPLES), 5)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    tol = REL_TOL[quant] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the softmax path: its probabilities are the softmax of its logits, and
    # softmax moves no probability by more than half the largest logit
    # change (|dp_i| <= p_i (1 - p_i) 2 max|dz|), so the JAX probabilities
    # lie within that of the port's
    probs = _port_engine(model, quant, with_softmax=True)(x)
    np.testing.assert_allclose(probs, _softmax(got.astype(np.float64)),
                               rtol=0, atol=1e-6)
    dz = np.abs(got - want).max(1, keepdims=True)
    dp = np.abs(probs - _softmax(want.astype(np.float64)))
    assert np.all(dp <= 0.5 * dz + 1e-6), (dp.max(), dz.max())


def test_golden_is_current(frames, jax_out):
    """The committed JAX golden equals a fresh JAX run (XLA:CPU may split
    sums differently across threads, hence 1e-5 of max |logit|)."""
    with np.load(GOLDEN) as g:
        golden = dict(g)
    assert list(golden["names"]) == [p.name for p in EXAMPLES]
    for s in (140, 240):
        np.testing.assert_array_equal(golden[f"frames_{s}"], frames[s])
    for model in MODELS:
        want = jax_out(model, "fp32")
        np.testing.assert_allclose(golden[model], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_port_preprocess_matches_jax_frames(frames):
    for s in (140, 240):
        got = np.concatenate([preprocess(load_image_rgb(str(p)), s)
                              for p in EXAMPLES])
        np.testing.assert_array_equal(got, frames[s])


def test_padding_and_overflow(frames, jax_out):
    eng = _port_engine("squeeze-ernet", "fp32")
    x = frames[140]
    small = eng(x[:3])
    assert small.shape == (3, 5)
    want = jax_out("squeeze-ernet", "fp32")[:3]
    np.testing.assert_allclose(small, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError):
        eng(np.zeros((GOLDEN_BATCH + 1, 140, 140, 3), np.uint8))
    with pytest.raises(ValueError):
        eng(np.zeros((1, 120, 120, 3), np.uint8))


def test_int8_engine_dir_raises(tmp_path):
    """An int8 engine directory without its act_scales.npz raises."""
    for name in ("spec.json", "params.npz"):
        (tmp_path / name).write_bytes(
            (int8_dir("squeeze-ernet") / name).read_bytes())
    with pytest.raises(ValueError, match="act_scales"):
        Engine.load(str(tmp_path), device="cpu")


def _int8_logits_engine(model, batch=GOLDEN_BATCH):
    loaded = Engine.load(str(int8_dir(model)), device="cpu")
    spec = dataclasses.replace(loaded.spec, batch_size=batch,
                               with_softmax=False)
    return Engine(spec, loaded.variables, loaded.act_scales, device="cpu")


@pytest.mark.parametrize("model", MODELS)
def test_int8_engine_dir_matches_jax_golden(frames, model):
    with np.load(GOLDEN_INT8) as g:
        want = g[model]
    got = _int8_logits_engine(model)(frames[image_size(model)])
    assert got.shape == want.shape == (len(EXAMPLES), 5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL["int8"] * np.abs(want).max())
    # the engine directory as committed: probabilities of those logits
    probs = Engine.load(str(int8_dir(model)), device="cpu")(
        frames[image_size(model)])
    np.testing.assert_allclose(probs, _softmax(got.astype(np.float64)),
                               rtol=0, atol=1e-6)


def test_int8_golden_is_current(frames):
    """The committed JAX int8 golden equals a fresh JAX run (1e-5 of max
    |logit|, as the fp32 golden)."""
    with np.load(GOLDEN_INT8) as g:
        golden = dict(g)
    assert list(golden["names"]) == [p.name for p in EXAMPLES]
    for model in MODELS:
        want = jax_int8_logits(model, frames[image_size(model)])
        np.testing.assert_allclose(golden[model], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_int8_engine_runs_the_qdq_block_path(frames):
    """Each ACFF block of an int8 engine holds its four scales, and the
    layers outside them are hooked: conv1, head/conv2 and head/fc."""
    eng = _int8_logits_engine("squeeze-ernet", batch=2)
    with open(int8_dir("squeeze-ernet") / "spec.json") as f:
        assert json.load(f)["quant"] == "int8"
    assert eng.dtype == torch.bfloat16
    assert eng.model.acff3.act_scales == tuple(
        float(eng.act_scales[f"acff3/{k}"])
        for k in ("conv1", "conv2", "conv3", "fused_conv"))
    hooked = [n for n, m in eng.model.named_modules()
              if m._forward_pre_hooks]
    assert hooked == ["conv1", "head.conv2", "head.fc"]


def test_build_int8_engine_needs_calib_images():
    with pytest.raises(ValueError, match="calib_images"):
        build_engine("squeeze-ernet", load_variables(
            params_path("squeeze-ernet")), quant="int8", batch_size=2,
            device="cpu")
    with pytest.raises(ValueError, match="act_scales"):
        Engine(EngineSpec("squeeze-ernet", "int8", 2),
               load_variables(params_path("squeeze-ernet")), device="cpu")


def test_int8_save_load_roundtrip(tmp_path, frames):
    eng = build_engine("squeeze-redconv", load_variables(
        params_path("squeeze-redconv")), quant="int8", batch_size=4,
        calib_images=frames[140][:4], calib_method="entropy", device="cpu")
    assert eng.spec.calib_method == "entropy" and len(eng.act_scales) == 22
    eng.save(str(tmp_path / "eng"))
    again = Engine.load(str(tmp_path / "eng"), device="cpu")
    assert again.spec == eng.spec
    assert sorted(again.act_scales) == sorted(eng.act_scales)
    for key, val in eng.act_scales.items():
        assert again.act_scales[key] == val
    np.testing.assert_array_equal(again(frames[140][:3]),
                                  eng(frames[140][:3]))


def test_save_load_roundtrip(tmp_path, frames):
    eng = _port_engine("squeeze-redconv", "bf16")
    eng.save(str(tmp_path / "eng"))
    again = Engine.load(str(tmp_path / "eng"), device="cpu")
    assert again.spec == eng.spec
    np.testing.assert_array_equal(again(frames[140][:2]),
                                  eng(frames[140][:2]))


def test_build_engine_verifies(frames):
    eng = build_engine("squeeze-ernet", load_variables(
        params_path("squeeze-ernet")), quant="fp16", batch_size=4,
        device="cpu")
    assert eng.spec.normalized_quant() == "bf16"
    assert eng.dtype == torch.bfloat16
    # BN running statistics stay fp32 in a bf16 engine
    assert eng.model.acff1.batch_norm.running_var.dtype == torch.float32
    assert eng.model.acff1.batch_norm.weight.dtype == torch.bfloat16
    assert eng(frames[140][:4]).shape == (4, 5)


def test_entry_points_default_to_cuda():
    """Without CUDA, the default device raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present, so the default device is valid")
    spec = EngineSpec("squeeze-ernet", "fp32", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(spec, load_variables(params_path("squeeze-ernet")))
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("ernet")
    with pytest.raises(RuntimeError, match="CUDA"):
        aider_predict.main(["--image", str(EXAMPLES[0]), "--engine",
                            "artifacts/engines/squeeze-ernet_bf16"])
