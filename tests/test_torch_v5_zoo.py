"""The port's v5 block zoo, ``up_to`` prefixes and v5 ``.pt`` import
against the JAX package.

Each block of the zoo sits in a yaml of its own at width 0.125 (a stem
conv, the block, a Detect); ``chip_smoke.py``'s ``ZOO_YAML``, which holds
them all with a two-level Detect, runs at width 0.125 whole and prefix by
prefix (``forward(up_to=k)``), and a Classify-headed yaml returns logits.
Weights are the JAX init with seeded random BN statistics, scales, biases
and Sum weights, loaded into the port by name. Outputs in fp32: rtol 1e-4
/ atol 1e-4 of max |map| (convs and attention summed in another order),
the gates of ``tests/test_torch_detector.py``.

The ``.pt`` import writes the reference layout with ``tests/torch_v5_ref.py``
(``TorchV5Model``: ultralytics keys, ``nn.MultiheadAttention`` inside C3TR)
as ``{'model': module, 'ema': module}`` and reads it in both packages:
the trees are equal (tolerance 0) with the EMA preferred or not, and with
``intersect`` into a model of another ``nc``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtdm_tpu.models.io import flatten_tree, unflatten_tree
from rtdm_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from rtdm_tpu.models.yolov5 import \
    load_yolov5_torch_checkpoint as jax_load_v5

import chip_smoke
from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
from rtdm_tpu_torch.models.yolov5 import (YoloV5,
                                          load_yolov5_torch_checkpoint)
from tests import torch_v5_ref as tvr

IMG = 64

HEADER = """
nc: 2
depth_multiple: {depth}
width_multiple: 0.125
anchors:
  - [10,13, 16,30, 33,23]
  - [30,61, 62,45, 59,119]
"""

# each block after a stem conv to 16 channels at stride 2
BLOCKS = {
    "BottleneckCSP": ["[-1, 2, BottleneckCSP, [128]]"],
    "BottleneckCSP_noshortcut": ["[-1, 1, BottleneckCSP, [64, False]]"],
    "C3TR": ["[-1, 2, C3TR, [128]]"],
    "DWConv": ["[-1, 2, DWConv, [128, 3, 2]]"],
    "CrossConv": ["[-1, 2, CrossConv, [128, 3, 1, 1, 1.0, True]]"],
    "GhostConv": ["[-1, 1, GhostConv, [256, 3, 2]]"],
    "GhostBottleneck_s1": ["[-1, 2, GhostBottleneck, [128, 3, 1]]"],
    "GhostBottleneck_s2": ["[-1, 1, GhostBottleneck, [256, 3, 2]]"],
    "MixConv2d": ["[-1, 2, MixConv2d, [128, [1, 3, 5], 1]]"],
    "Sum": ["[-1, 1, Conv, [128, 3, 1]]", "[[-1, 0], 1, Sum, [True]]"],
    "Sum_unweighted": ["[-1, 1, Conv, [128, 3, 1]]",
                       "[[-1, 0, 1], 1, Sum, [False]]"],
    "Contract": ["[-1, 1, Contract, [2]]"],
    "Expand": ["[-1, 1, Expand, [2]]"],
}


def block_yaml(lines):
    body = ",\n   ".join(["[-1, 1, Conv, [128, 3, 2]]"] + lines)
    return (HEADER.format(depth=1.0) + "backbone:\n  [" + body + ",\n  ]\n"
            "head:\n  [[[-1], 1, Detect, [nc, anchors]]]\n")


# every block in one graph, two Detect levels: chip_smoke.py's at width
# 0.125
ZOO_YAML = chip_smoke.ZOO_YAML.replace("width_multiple: 0.50",
                                       "width_multiple: 0.125")


CLASSIFY_YAML = HEADER.format(depth=1.0) + """backbone:
  [[-1, 1, Conv, [128, 3, 2]],
   [-1, 1, BottleneckCSP, [128]],
   [-1, 1, Conv, [256, 3, 2]],
  ]
head:
  [[[1, 2], 1, Classify, [5]]]
"""


def _randomized(variables, seed):
    """The JAX init with random BN statistics, scales, biases and Sum
    weights, so that every leaf matters."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.device_get(variables))
    for key, val in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "var":
            flat[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
        elif leaf in ("mean", "bias", "w") or leaf.endswith("_b"):
            flat[key] = (0.1 * rng.normal(size=val.shape)).astype(np.float32)
        elif leaf == "scale":
            flat[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    return unflatten_tree(flat)


def _both(yaml_text, seed, img=IMG):
    model = JaxYoloV5(yaml_text=yaml_text)
    variables = _randomized(model.init(jax.random.key(seed),
                                       jnp.zeros((1, img, img, 3))), seed)
    net = YoloV5(yaml_text)
    net.load_state_dict(torch_state_dict_from_variables(variables),
                        strict=True)
    return model, variables, net.eval()


def _frames(seed, img=IMG, n=2):
    return np.random.default_rng(seed).uniform(0, 1, (n, img, img, 3)) \
        .astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_jax_fp32(block):
    text = block_yaml(BLOCKS[block])
    model, variables, net = _both(text, 3)
    x = _frames(4)
    want = jax.jit(lambda v, x: model.apply(v, x))(variables, x)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 1
    _close(got[0].numpy(), want[0])


@pytest.fixture(scope="module")
def zoo():
    return _both(ZOO_YAML, 5)


def test_zoo_graph_matches_jax_fp32(zoo):
    model, variables, net = zoo
    assert "width_multiple: 0.125" in ZOO_YAML
    x = _frames(6)
    want = jax.jit(lambda v, x: model.apply(v, x))(variables, x)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("up_to", [0, 2, 5, 8, 9, 10, 13, 16, 18])
def test_up_to_prefix_matches_jax(zoo, up_to):
    model, variables, net = zoo
    x = _frames(7, n=1)
    want = model.apply(variables, x, up_to=up_to)
    with torch.inference_mode():
        got = net(torch.from_numpy(x), up_to=up_to)
    _close(got.numpy(), want)


def test_classify_head_matches_jax():
    model, variables, net = _both(CLASSIFY_YAML, 8)
    x = _frames(9)
    want = model.apply(variables, x)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert got.shape == (2, 5)
    _close(got.numpy(), want)


# the blocks that tests/torch_v5_ref.py builds with the reference's keys
REF_YAML = HEADER.format(depth=1.0) + """backbone:
  [[-1, 1, Focus, [64, 3]],
   [-1, 1, Conv, [128, 3, 2]],
   [-1, 2, BottleneckCSP, [128]],
   [-1, 1, GhostConv, [256, 3, 2]],
   [-1, 2, GhostBottleneck, [256, 3, 1]],
   [-1, 1, GhostBottleneck, [256, 3, 2]],
   [-1, 2, DWConv, [256, 3, 1]],
   [-1, 1, SPP, [256, [5, 9, 13]]],
   [-1, 2, C3TR, [256]],
  ]
head:
  [[-1, 1, Conv, [128, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 4], 1, Concat, [1]],
   [-1, 1, C3, [128, False]],
   [[12, 8], 1, Detect, [nc, anchors]],
  ]
"""


def _reference_model(seed):
    from rtdm_tpu_torch.utils import yaml_io
    torch.manual_seed(seed)
    tm = tvr.TorchV5Model(yaml_io.loads(REF_YAML)).eval()
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 1.5)
    return tm


@pytest.fixture(scope="module")
def v5_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("v5pt") / "v5.pt"
    model, ema = _reference_model(0), _reference_model(1)
    torch.save({"model": model, "ema": ema}, path)
    return str(path), model, ema


def _init(yaml_text, nc=None):
    model = JaxYoloV5(yaml_text=yaml_text, num_classes=nc)
    return model, jax.device_get(model.init(jax.random.key(0),
                                            jnp.zeros((1, IMG, IMG, 3))))


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_v5_pt_import_matches_jax(v5_checkpoint, prefer_ema):
    """Tolerance 0 against the JAX import; the port's graph on the
    imported tree against the reference-layout torch module it came from
    (NCHW), at the fp32 gates."""
    path, model, ema = v5_checkpoint
    jmodel, init = _init(REF_YAML)
    got = load_yolov5_torch_checkpoint(init, path, prefer_ema=prefer_ema)
    _assert_trees_equal(got, jax_load_v5(init, path, prefer_ema=prefer_ema))
    net = YoloV5(REF_YAML)
    net.load_state_dict(torch_state_dict_from_variables(got), strict=True)
    x = _frames(10)
    with torch.inference_mode():
        port = net.eval()(torch.from_numpy(x))
        ref = (ema if prefer_ema else model)(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    for p, r in zip(port, ref):
        _close(p.numpy(), r.permute(0, 2, 3, 1).numpy())


def test_v5_pt_intersect_matches_jax(v5_checkpoint):
    """A checkpoint of nc=2 into a model of nc=3: the Detect convs keep the
    init, the rest loads; without ``intersect`` both packages raise."""
    path, _, _ = v5_checkpoint
    _, init = _init(REF_YAML, nc=3)
    with pytest.raises(ValueError, match="shape-mismatched"):
        load_yolov5_torch_checkpoint(init, path)
    got = load_yolov5_torch_checkpoint(init, path, intersect=True)
    _assert_trees_equal(got, jax_load_v5(init, path, intersect=True))
    np.testing.assert_array_equal(got["params"]["m13_m0"]["kernel"],
                                  init["params"]["m13_m0"]["kernel"])
    assert not np.array_equal(got["params"]["m1"]["conv"]["kernel"],
                              init["params"]["m1"]["conv"]["kernel"])
