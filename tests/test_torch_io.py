"""Weight archives and the JAX-tree <-> state_dict mapping of the port,
against ``rtdm_tpu.models.io``. Every comparison here is exact: the port
only moves and transposes arrays."""

import json
from pathlib import Path

import numpy as np
import pytest

from rtdm_tpu.models.io import infer_num_classes as jax_infer_num_classes
from rtdm_tpu.models.io import load_variables as jax_load_variables
from rtdm_tpu_torch.models import create_model
from rtdm_tpu_torch.models.io import (flatten_tree, infer_num_classes,
                                      load_variables, save_variables,
                                      torch_state_dict_from_variables,
                                      variables_from_torch_state_dict)

ENGINES = Path(__file__).resolve().parents[1] / "artifacts" / "engines"
CLASSIFIER_DIRS = sorted(p.name for p in ENGINES.iterdir()
                         if p.is_dir() and p.name.split("_")[0] in
                         ("ernet", "squeeze-ernet", "squeeze-redconv"))


def _assert_trees_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_all_classifier_dirs_listed():
    assert len(CLASSIFIER_DIRS) == 6


@pytest.mark.parametrize("name", CLASSIFIER_DIRS)
def test_engine_dir_loads_strict(name):
    path = str(ENGINES / name / "params.npz")
    variables = load_variables(path)
    _assert_trees_equal(variables, jax_load_variables(path))
    assert infer_num_classes(variables) == jax_infer_num_classes(variables)
    with open(ENGINES / name / "spec.json") as f:
        spec = json.load(f)
    model = create_model(spec["model"], device="cpu",
                         num_classes=spec["num_classes"])
    state = torch_state_dict_from_variables(variables)
    result = model.load_state_dict(state, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert len(state) == len(flatten_tree(variables))


def test_sealed_npz_dequantizes_like_jax(tmp_path, rng):
    flat = {
        "params/conv1/kernel.q": rng.integers(-127, 128, (3, 3, 3, 16),
                                              dtype=np.int8),
        "params/conv1/kernel.s": rng.uniform(0.001, 0.02, (16,)).astype(
            np.float32),
        "params/head/fc/kernel": rng.normal(size=(20, 5)).astype(np.float32),
        "params/head/fc/bias": rng.normal(size=(5,)).astype(np.float32),
        "batch_stats/acff1/batch_norm/var": rng.uniform(
            0.5, 1.5, (64,)).astype(np.float32),
    }
    path = str(tmp_path / "sealed.npz")
    np.savez(path, **flat)
    got = load_variables(path)
    _assert_trees_equal(got, jax_load_variables(path))
    assert got["params"]["conv1"]["kernel"].dtype == np.float32


def test_port_save_roundtrips_through_jax_load(tmp_path):
    path = str(ENGINES / "squeeze-redconv_bf16" / "params.npz")
    variables = load_variables(path)
    model = create_model("squeeze-redconv", device="cpu")
    model.load_state_dict(torch_state_dict_from_variables(variables),
                          strict=True)
    back = variables_from_torch_state_dict(model.state_dict())
    out = save_variables(str(tmp_path / "roundtrip"), back)
    assert out.endswith(".npz")
    _assert_trees_equal(jax_load_variables(out), variables)


def test_pt_checkpoints_wait_for_a_later_slice(tmp_path):
    """The reference's ``.pt`` state dict of a committed engine loads as the
    JAX package loads it, and as the ``.npz`` it came from (tolerance 0;
    the layouts in ``tests/test_torch_import.py``)."""
    from tests.torch_checkpoints import save_classifier_pt
    variables = load_variables(str(ENGINES / "squeeze-ernet_bf16"
                                   / "params.npz"))
    path = save_classifier_pt(tmp_path / "model.pt", variables, "state_dict")
    got = load_variables(path)
    _assert_trees_equal(got, jax_load_variables(path))
    _assert_trees_equal(got, variables)
