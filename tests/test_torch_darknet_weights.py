"""The port's darknet ``.weights`` reader and writer and the fork's ``.pt``
import against the JAX package.

Two trees: the committed yolov4-tiny engine (its fused cfg, plain convs
with biases, dequantized kernels) and the narrow cfg of
``tests/test_torch_detector.py`` (BN convs, a grouped route, a weighted
shortcut, the fork's ``[acff]``) with seeded random values in every leaf.
Both packages write byte-equal ``.weights`` files; each reads either
package's file to the tree the JAX package reads (tolerance 0: the
loaders only reorder and transpose). The fork's ``{'model': state_dict}``
checkpoint, ACFF blocks and fusion weights included, loads to the tree it
was written from in both. The detector loader routes every format.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtdm_tpu.models.darknet import Darknet as JaxDarknet
from rtdm_tpu.models.darknet import \
    load_darknet_torch_checkpoint as jax_load_fork
from rtdm_tpu.models.darknet import load_darknet_weights as jax_load_weights
from rtdm_tpu.models.darknet import save_darknet_weights as jax_save_weights

from rtdm_tpu_torch.models.darknet import (load_darknet_torch_checkpoint,
                                           load_darknet_weights,
                                           save_darknet_weights)
from rtdm_tpu_torch.models.io import flatten_tree, load_variables
from tests.test_torch_detector import CFG
from tests.torch_checkpoints import darknet_fork_state_dict, randomized_tree

ENGINE = (Path(__file__).resolve().parents[1] / "artifacts" / "engines"
          / "yolov4-tiny-mini_int8")


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module", params=["engine", "narrow"])
def tree(request):
    """(cfg text, values, a JAX init of the same shapes)."""
    if request.param == "engine":
        text = (ENGINE / "model.txt").read_text()
        values = load_variables(str(ENGINE / "params.npz"))
        return text, values, values
    model = JaxDarknet(cfg_text=CFG)
    init = jax.device_get(model.init(jax.random.key(0),
                                     jnp.zeros((1, 64, 64, 3))))
    return CFG, randomized_tree(init, 11), init


def test_weights_files_are_byte_equal(tmp_path, tree):
    text, values, _ = tree
    port, jax_file = tmp_path / "port.weights", tmp_path / "jax.weights"
    save_darknet_weights(values, text, str(port))
    jax_save_weights(values, text, str(jax_file))
    assert port.read_bytes() == jax_file.read_bytes()


def test_weights_round_trip_matches_jax(tmp_path, tree):
    """Both packages read the file into the init to the same tree; its
    convs and BatchNorms are the values written, every other leaf (the
    ACFF blocks, the shortcut weights) keeps the init."""
    text, values, init = tree
    path = str(tmp_path / "w.weights")
    jax_save_weights(values, text, path)
    got = load_darknet_weights(init, text, path)
    _assert_trees_equal(got, jax_load_weights(init, text, path))
    flat_got, flat_values = flatten_tree(got), flatten_tree(values)
    flat_init = flatten_tree(init)
    for key, val in flat_got.items():
        from_file = re.match(r"\w+/l\d+_(conv|bn)/", key) is not None
        want = flat_values[key] if from_file else flat_init[key]
        np.testing.assert_array_equal(val, want, err_msg=key)


def test_weights_size_mismatch_raises_in_both(tmp_path, tree):
    text, values, init = tree
    path = tmp_path / "w.weights"
    save_darknet_weights(values, text, str(path))
    path.write_bytes(path.read_bytes() + np.zeros(3, np.float32).tobytes())
    for load in (load_darknet_weights, jax_load_weights):
        with pytest.raises(ValueError, match="size mismatch"):
            load(init, text, str(path))


def test_fork_pt_matches_jax(tmp_path, tree):
    """The fork's checkpoint (``module_list.{i}.Conv2d``, ``BatchNorm2d``,
    ``acff_{i}.<conv1..3|fused_conv|batch_norm>``, a shortcut's ``w``)
    loads to the tree it was written from, as in the JAX package."""
    text, values, init = tree
    path = str(tmp_path / "fork.pt")
    state = darknet_fork_state_dict(values, text)
    if "acff" in text:
        assert any(".acff_" in k for k in state)
        assert any(k.endswith(".w") for k in state)
    torch.save({"model": state, "epoch": 1}, path)
    got = load_darknet_torch_checkpoint(init, text, path)
    _assert_trees_equal(got, jax_load_fork(init, text, path))
    _assert_trees_equal(got, values)


def test_non_fork_pt_raises_in_both(tmp_path):
    path = str(tmp_path / "other.pt")
    torch.save({"model.0.conv.weight": torch.zeros(1)}, path)
    for load in (load_darknet_torch_checkpoint, jax_load_fork):
        with pytest.raises(ValueError, match="not a darknet-fork"):
            load({"params": {}}, CFG, path)


def test_detection_model_loads_every_format(tmp_path):
    """``load_detection_model`` opens the given path in each format:
    ``.npz``, ``.weights`` and the fork's ``.pt`` give the engine's tree;
    an unknown suffix raises."""
    from rtdm_tpu_torch.export.detector import load_detection_model
    cfg = tmp_path / "v4tiny.cfg"
    cfg.write_text((ENGINE / "model.txt").read_text())
    values = load_variables(str(ENGINE / "params.npz"))
    weights, pt = tmp_path / "v.weights", tmp_path / "v.pt"
    save_darknet_weights(values, cfg.read_text(), str(weights))
    torch.save({"model": darknet_fork_state_dict(values, cfg.read_text())},
               pt)
    for path in (ENGINE / "params.npz", weights, pt):
        _, got, heads = load_detection_model(str(cfg), str(path), 416)
        _assert_trees_equal(got, values)
        assert len(heads) == 3
    with pytest.raises(ValueError, match="load .npz"):
        load_detection_model(str(cfg), str(tmp_path / "v.onnx"), 416)
