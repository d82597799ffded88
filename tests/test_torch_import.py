"""The port's torch ``.pt`` classifier import against the JAX package.

The committed Squeeze_ErNET, Squeeze_RedConv and ErNET trees are written
as the reference's checkpoints in its three layouts (a state dict, the
trainer's ``{'model_state_dict': ...}``, a pickled module whose classes
cannot be imported when it is read: the stub unpickler stands in for
them) and read back in both packages. Tolerance 0: the loaders only
convert layouts (OIHW -> HWIO, Linear transposed, BatchNorm split into
params and batch_stats), so the trees equal the JAX package's and the
``.npz`` they came from. Then the entry points that load a classifier
take the ``.pt``: ``Engine``, the veto and ``aider_train --pretrained``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from rtdm_tpu.models.io import load_variables as jax_load_variables
from rtdm_tpu.models.torch_import import \
    infer_classifier_arch as jax_infer_arch
from rtdm_tpu.models.torch_import import \
    load_torch_state_dict as jax_load_state_dict

from rtdm_tpu_torch.models.io import (flatten_tree, load_variables,
                                      torch_state_dict_from_variables)
from rtdm_tpu_torch.models.torch_import import (infer_classifier_arch,
                                                load_torch_state_dict)
from tests.torch_checkpoints import (CLASSIFIER_LAYOUTS, classifier_state_dict,
                                     save_classifier_pt)

ENGINES = Path(__file__).resolve().parents[1] / "artifacts" / "engines"
MODELS = ("squeeze-ernet", "squeeze-redconv", "ernet")


def _npz(model):
    return str(ENGINES / f"{model}_bf16" / "params.npz")


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("layout", CLASSIFIER_LAYOUTS)
@pytest.mark.parametrize("model", MODELS)
def test_classifier_pt_matches_jax(tmp_path, model, layout):
    variables = load_variables(_npz(model))
    path = save_classifier_pt(tmp_path / f"{model}.pt", variables, layout,
                              module_name=f"legacy_{model}_{layout}"
                              .replace("-", "_"))
    got = load_variables(path)
    _assert_trees_equal(got, jax_load_variables(path))
    _assert_trees_equal(got, variables)
    state = load_torch_state_dict(path)
    assert infer_classifier_arch(state) == jax_infer_arch(
        jax_load_state_dict(path)) == model


def test_pth_suffix_and_bad_formats(tmp_path):
    variables = load_variables(_npz("squeeze-ernet"))
    path = tmp_path / "w.pth"
    torch.save(classifier_state_dict(variables), path)
    _assert_trees_equal(load_variables(str(path)), variables)
    bad = tmp_path / "bad.pt"
    torch.save([1, 2, 3], bad)
    with pytest.raises(ValueError, match="unsupported checkpoint"):
        load_variables(str(bad))
    odd = tmp_path / "odd.pt"
    torch.save({"conv1.weight": torch.zeros(2, 3, 3, 3, 3)}, odd)
    with pytest.raises(ValueError, match="unexpected weight rank"):
        load_variables(str(odd))


def test_model_key_holding_a_tensor_stays_a_state_dict(tmp_path):
    """A state dict whose 'model' key is a tensor is not a ``{'model':
    ...}`` checkpoint (the JAX loader's rule)."""
    path = tmp_path / "m.pt"
    torch.save({"model": torch.ones(3), "fc.bias": torch.zeros(5)}, path)
    got = load_torch_state_dict(str(path))
    assert sorted(got) == ["fc.bias", "model"]
    assert sorted(jax_load_state_dict(str(path))) == sorted(got)


def test_pt_engine_equals_npz_engine(tmp_path):
    from rtdm_tpu_torch.export.engine import Engine, EngineSpec
    variables = load_variables(_npz("squeeze-ernet"))
    path = save_classifier_pt(tmp_path / "s.pt", variables, "state_dict")
    frames = np.random.default_rng(0).integers(0, 256, (2, 140, 140, 3),
                                               dtype=np.uint8)
    spec = EngineSpec(model="squeeze-ernet", batch_size=2)
    want = Engine(spec, variables, device="cpu")(frames)
    got = Engine(spec, load_variables(path), device="cpu")(frames)
    np.testing.assert_array_equal(got, want)


def test_veto_loads_pt(tmp_path):
    from rtdm_tpu_torch.export.second_stage import build_second_stage
    path = save_classifier_pt(tmp_path / "v.pt",
                              load_variables(_npz("squeeze-ernet")),
                              "model_state_dict")
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 140, 140, 3), dtype=np.uint8))
    det = torch.tensor([[[10., 12., 90., 100., 0.9, 0.]],
                        [[0., 0., 140., 140., 0.8, 1.]]])
    want = build_second_stage("squeeze-ernet", _npz("squeeze-ernet"),
                              device="cpu").logits(frames, det, [1, 1])
    got = build_second_stage("squeeze-ernet", path,
                             device="cpu").logits(frames, det, [1, 1])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_aider_train_pretrained_pt(tmp_path):
    from rtdm_tpu_torch.cli import aider_train
    from rtdm_tpu_torch.models.ernet import create_model
    variables = load_variables(_npz("squeeze-redconv"))
    path = save_classifier_pt(tmp_path / "r.pt", variables, "module",
                              module_name="legacy_pretrained")
    model = create_model("squeeze-redconv", device="cpu")
    aider_train._load_pretrained(model, path)
    want = torch_state_dict_from_variables(variables)
    got = model.state_dict()
    assert want.keys() <= got.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v.to(got[k].dtype), rtol=0,
                                   atol=0)
