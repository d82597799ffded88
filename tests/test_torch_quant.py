"""The port's int8 quantization (``rtdm_tpu_torch/quant/``) against the JAX
package's (``rtdm_tpu/quant/``).

- QDQ of activations: bit-equal to the JAX ``fake_quant_tensor`` as the JAX
  int8 engine runs it, compiled with its scale a constant (XLA multiplies
  by the scale's fp32 reciprocal), ties at .5 included.
- Weight QDQ (``quantize_kernel_per_channel``, ``seal_kernel``,
  ``quantize_params``): bit-equal, ties at .5 included.
- Calibration on the committed Squeeze_ErNET weights and the 10 example
  frames: the same 19 keys; percentile scales within rtol 1e-4 (the fp32
  activations differ by summation order only); entropy scales within
  rtol 1e-2 (the KL search tries thresholds 8 of 2048 bins apart, so a
  histogram count that moves can move the threshold by a step; on these
  frames both agree within 7e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdm_tpu.models import create_model as jax_create_model
from rtdm_tpu.models.io import load_variables as jax_load_variables
from rtdm_tpu.quant import calibrate as jax_cal
from rtdm_tpu.quant import int8 as jax_int8
from rtdm_tpu_torch.export.engine import EngineSpec, load_model
from rtdm_tpu_torch.models import ACFF
from rtdm_tpu_torch.models.io import load_variables
from rtdm_tpu_torch.quant import calibrate, int8
from tests.torch_port_goldens import example_frames, params_path

SCALES = [0.5, 0.020328523591160774, 0.8348406553268433, 3.0 / 7.0]


def _ties(scale):
    """Values whose x * reciprocal(scale) is exactly k + 1/2 where the
    reciprocal is exact (powers of two), and every k in -130..130."""
    k = np.arange(-130, 131, dtype=np.float32)
    return np.concatenate([(k + 0.5) * np.float32(scale), k * scale])


@pytest.mark.parametrize("scale", SCALES)
def test_fake_quant_matches_the_compiled_jax_qdq(rng, scale):
    x = np.concatenate([
        rng.normal(size=200_000).astype(np.float32) * 60 * scale,
        _ties(scale).astype(np.float32)])
    want = np.asarray(jax.jit(
        lambda v: jax_int8.fake_quant_tensor(v, scale))(jnp.asarray(x)))
    got = int8.fake_quant_tensor(torch.from_numpy(x), scale).numpy()
    np.testing.assert_array_equal(got, want)
    codes = np.round(got / np.float32(scale))
    assert codes.min() == -127 and codes.max() == 127     # clipped both ways


def test_weight_qdq_matches_jax(rng):
    k = rng.normal(size=(3, 3, 16, 8)).astype(np.float32)
    k[..., 0] = np.linspace(-127, 127, 144).reshape(3, 3, 16)   # scale 1
    k[0, 0, :8, 0] = np.arange(8) + 0.5                         # ties
    np.testing.assert_array_equal(int8.quantize_kernel_per_channel(k),
                                  jax_int8.quantize_kernel_per_channel(k))
    for got, want in zip(int8.seal_kernel(k), jax_int8.seal_kernel(k)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    q, s = int8.seal_kernel(k)
    np.testing.assert_array_equal(q * s, int8.quantize_kernel_per_channel(k))
    params = jax_load_variables(params_path("squeeze-ernet"))["params"]
    got = int8.quantize_params(params)
    want = jax_int8.quantize_params(params)
    flat = {}

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for key in a:
                walk(a[key], b[key], f"{path}/{key}")
        else:
            flat[path] = a
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    walk(got, want)
    # every kernel is QDQ'd (conv, depthwise, dense), nothing else changes
    assert sum(p.endswith("kernel") for p in flat) == 19
    np.testing.assert_array_equal(got["acff1"]["conv1"]["bias"],
                                  params["acff1"]["conv1"]["bias"])


@pytest.mark.parametrize("method", ["percentile", "entropy"])
def test_compute_scale_matches_jax(rng, method):
    v = np.abs(rng.standard_t(3, size=50_000)).astype(np.float32)
    assert calibrate.compute_scale(v, method) == \
        jax_cal.compute_scale(v, method)
    assert calibrate.compute_scale(np.zeros(4), method) == 1.0


@pytest.fixture(scope="module")
def frames():
    return example_frames(140)


def _port_fp32_model(model="squeeze-ernet"):
    spec = EngineSpec(model, "fp32", 1, 140)
    return load_model(spec, load_variables(params_path(model)), "cpu",
                      torch.float32)


@pytest.mark.parametrize("method", ["percentile", "entropy"])
def test_calibrate_classifier_matches_jax(frames, method):
    variables = jax_load_variables(params_path("squeeze-ernet"))
    want = jax_cal.calibrate_classifier(jax_create_model("squeeze-ernet"),
                                        variables, frames, method=method,
                                        batch_size=4)
    got = calibrate.calibrate_classifier(_port_fp32_model(), frames,
                                         method=method, batch_size=4)
    assert sorted(got) == sorted(want) and len(got) == 19
    rtol = {"percentile": 1e-4, "entropy": 1e-2}[method]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)
    # the three branches of a block see one input, so one scale
    assert got["acff2/conv1"] == got["acff2/conv2"] == got["acff2/conv3"]


def test_calibrate_detector_matches_jax(frames):
    """The detector entry (u8/255 preprocessing, batches of 16) on a
    classifier, the port's only model yet."""
    variables = jax_load_variables(params_path("squeeze-ernet"))
    want = jax_cal.calibrate_detector(jax_create_model("squeeze-ernet"),
                                      variables, frames)
    got = calibrate.calibrate_detector(_port_fp32_model(), frames)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)


def test_calibration_subsamples_as_jax_does(frames):
    """A sample cap small enough that every input is subsampled: the same
    strided samples reach the reducer, raveled in NHWC order."""
    variables = jax_load_variables(params_path("squeeze-ernet"))
    want = jax_cal.calibrate_classifier(jax_create_model("squeeze-ernet"),
                                        variables, frames[:3],
                                        sample_cap=1 << 10)
    got = calibrate.calibrate_classifier(_port_fp32_model(), frames[:3],
                                         sample_cap=1 << 10)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)


def test_quantize_classifier_hooks_the_layers_outside_the_blocks():
    model = _port_fp32_model("squeeze-redconv")
    scales = {k: np.float32(0.05) for k in
              ("conv1", "conv_red1", "head/conv2", "head/fc",
               "acff1/conv1", "acff1/conv2", "acff1/conv3",
               "acff1/fused_conv")}
    handles = int8.quantize_classifier(model, scales)
    assert len(handles) == 4          # conv_red2/3 have no scale: no hook
    assert model.acff1.act_scales == (float(np.float32(0.05)),) * 4
    assert model.acff2.act_scales is None
    assert not model.conv1.round_output and not model.conv_red3.round_output
    assert model.conv_red2.round_output
    assert model.head.sequential_pool
    scales.pop("acff1/conv3")
    with pytest.raises(ValueError, match="acff1"):
        int8.quantize_classifier(_port_fp32_model("squeeze-redconv"), scales)


def test_layer_by_layer_runs_only_inside_its_block(frames):
    model = _port_fp32_model()
    blocks = [m for m in model.modules() if isinstance(m, ACFF)]
    with calibrate.layer_by_layer(model):
        assert all(m.unfused for m in blocks)
    assert not any(m.unfused for m in blocks)
