"""The detector training layers and losses of the port against the JAX
package, on seeded numpy inputs at narrow widths:

- ROADMAP faults 8 and 9: the BatchNorm momenta of the detectors (darknet
  0.003, v5 0.03) and the darknet ``[acff]`` block's dropout in training.
  One train-mode forward of a narrow darknet cfg (BN convs and an
  ``[acff]`` block) and of a narrow v5 yaml: every running statistic
  within ``STATS_TOL`` (2e-6) of max |stat| of its leaf from the jitted
  JAX forward (read: darknet 1.18e-6, at the ``[acff]`` BN's variance
  three layers deep, and the port in float64 1.24e-6 from JAX, so the
  reading is JAX's own fp32 rounding; v5 3.0e-7). Control: torch's
  momentum 0.1 on every BN (the parent's) misses it. The ``[acff]`` output, where the port's dropout kept it,
  equal to the JAX block without dropout over 0.8 (within ``OUT_TOL`` of
  max |out|), with a keep share near 0.8.
- ``ops/boxes.py``: ``bbox_iou`` in all four modes and ``wh_iou_matrix``
  within 1e-6 (absolute; IoUs are O(1)) of the jitted JAX functions.
- ``train/yolo_loss.py``: both losses, their components and the gradient
  of the loss to every raw map against ``jax.value_and_grad`` of the
  jitted JAX loss, on a batch whose labels collide in cells (two labels
  with their centres in one cell and one anchor, where the scatter-max
  decides ``tobj``): loss and components within ``LOSS_TOL`` (1e-5)
  relative, gradients within ``GRAD_TOL`` (1e-5) of max |grad|. Control: a
  last-write-wins ``tobj`` (``chip_smoke._lww_loss``) misses the loss gate
  on that batch, which has colliding candidates.
- ``train/ema.py``: five EMA updates against JAX's within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import jax
import jax.numpy as jnp

STATS_TOL = 2e-6
OUT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5

# a narrow darknet cfg: two BN convs (one frelu), a maxpool, and an [acff]
# block whose output is the head's raw map (na * (5 + nc) = 21 channels)
DARKNET_CFG = """[net]
width=64
height=64

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=frelu

[acff]
filters=21
size=3

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58
classes=2
"""

# a narrow v5 yaml: Focus, Conv, C3, SPP, upsample + concat, Detect
V5_YAML = """nc: 2
depth_multiple: 0.33
width_multiple: 0.125
anchors:
  - [10,13, 16,30, 33,23]
  - [30,61, 62,45, 59,119]
backbone:
  [[-1, 1, Focus, [64, 3]],
   [-1, 1, Conv, [128, 3, 2]],
   [-1, 3, C3, [128]],
   [-1, 1, Conv, [256, 3, 2]],
   [-1, 1, SPP, [256, [5, 9, 13]]],
  ]
head:
  [[-1, 1, Conv, [128, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 2], 1, Concat, [1]],
   [-1, 1, C3, [128, False]],
   [[8, 4], 1, Detect, [nc, anchors]],
  ]
"""


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _perturbed(variables, rng):
    """The JAX init with BN scales, biases and running statistics drawn at
    random, so that both terms of the running update count."""
    from rtdm_tpu_torch.models.io import flatten_tree, unflatten_tree
    flat = flatten_tree(jax.device_get(dict(variables)))
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if k.startswith("batch_stats/") and leaf == "mean":
            flat[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
        elif k.startswith("batch_stats/"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif leaf == "scale":
            flat[k] = rng.normal(1, 0.2, v.shape).astype(np.float32)
    return unflatten_tree(flat)


def _darknet_pair(rng, dropout_rate=0.2):
    from rtdm_tpu.models.darknet import Darknet as JaxDarknet

    from rtdm_tpu_torch.models.darknet import Darknet
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    jmodel = JaxDarknet(cfg_text=DARKNET_CFG, dropout_rate=dropout_rate)
    variables = _perturbed(jmodel.init(jax.random.key(0), jnp.zeros(
        (1, 64, 64, 3), jnp.float32)), rng)
    model = Darknet(DARKNET_CFG)
    model.load_state_dict(torch_state_dict_from_variables(variables))
    return jmodel, variables, model


def _v5_pair(rng):
    from rtdm_tpu.models.yolov5 import YoloV5 as JaxYoloV5

    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    from rtdm_tpu_torch.models.yolov5 import YoloV5
    jmodel = JaxYoloV5(yaml_text=V5_YAML)
    variables = _perturbed(jmodel.init(jax.random.key(0), jnp.zeros(
        (1, 64, 64, 3), jnp.float32)), rng)
    model = YoloV5(V5_YAML)
    model.load_state_dict(torch_state_dict_from_variables(variables))
    return jmodel, variables, model


def _jax_train_forward(jmodel, variables, x, rng_seed=0):
    fn = jax.jit(lambda v, a: jmodel.apply(
        v, a, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(rng_seed)}))
    raw, mut = fn(variables, jnp.asarray(x))
    return [np.asarray(r) for r in raw], mut["batch_stats"]


def _port_train_forward(model, x):
    from rtdm_tpu_torch.models.io import (flatten_tree,
                                          variables_from_torch_state_dict)
    from rtdm_tpu_torch.models.layers import set_dropout_generator
    model.train()
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        raw = model(torch.from_numpy(x))
    stats = flatten_tree(variables_from_torch_state_dict(
        model.state_dict())["batch_stats"])
    return [r.numpy() for r in raw], stats


def _stats_gap(want_tree, got_flat):
    from rtdm_tpu_torch.models.io import flatten_tree
    want = flatten_tree(jax.device_get(want_tree))
    assert set(want) == set(got_flat)
    return max(float(np.abs(got_flat[k] - want[k]).max()
                     / np.abs(want[k]).max()) for k in want)


@pytest.mark.parametrize("family", ["darknet", "yolov5"])
def test_fault8_bn_running_statistics_match_jax(family):
    rng = np.random.default_rng(1)
    jmodel, variables, model = (_darknet_pair(rng) if family == "darknet"
                                else _v5_pair(rng))
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    _, want = _jax_train_forward(jmodel, variables, x)
    _, got = _port_train_forward(model, x)
    gap = _stats_gap(want, got)
    assert gap <= STATS_TOL, f"{family} running statistics {gap}"


@pytest.mark.parametrize("family", ["darknet", "yolov5"])
def test_fault8_control_torch_momentum_misses(family):
    from rtdm_tpu_torch.models.layers import BatchNorm
    rng = np.random.default_rng(1)
    jmodel, variables, model = (_darknet_pair(rng) if family == "darknet"
                                else _v5_pair(rng))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 0.1
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    _, want = _jax_train_forward(jmodel, variables, x)
    _, got = _port_train_forward(model, x)
    assert _stats_gap(want, got) > STATS_TOL


def test_fault9_acff_dropout_in_training():
    rng = np.random.default_rng(2)
    jmodel, variables, model = _darknet_pair(rng, dropout_rate=0.0)
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    (want,), _ = _jax_train_forward(jmodel, variables, x)
    (got,), _ = _port_train_forward(model, x)
    kept = got != 0
    share = kept.mean()
    assert 0.75 <= share <= 0.85, f"dropout kept {share} of the outputs"
    err = np.abs(got[kept] - want[kept] / np.float32(0.8)).max()
    assert err <= OUT_TOL * np.abs(want).max() / 0.8


def test_bn_burn_in_keeps_the_running_statistics():
    from rtdm_tpu_torch.models.layers import set_bn_update
    rng = np.random.default_rng(3)
    _, _, model = _darknet_pair(rng)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    set_bn_update(model, False)
    _port_train_forward(model, rng.uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32))
    set_bn_update(model, True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("mode", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("xywh", [True, False])
def test_bbox_iou_matches_jax(mode, xywh):
    from rtdm_tpu.ops.boxes import bbox_iou as jax_iou

    from rtdm_tpu_torch.ops.boxes import bbox_iou
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 20, (500, 4)).astype(np.float32)
    b = rng.uniform(0, 20, (500, 4)).astype(np.float32)
    if not xywh:
        a[:, 2:] += a[:, :2]
        b[:, 2:] += b[:, :2]
    kw = {mode: True} if mode != "iou" else {}
    want = np.asarray(jax.jit(lambda p, q: jax_iou(p, q, xywh=xywh, **kw))(
        a, b))
    got = bbox_iou(torch.from_numpy(a), torch.from_numpy(b), xywh=xywh,
                   **kw).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_wh_iou_matrix_matches_jax():
    from rtdm_tpu.ops.boxes import wh_iou_matrix as jax_wh

    from rtdm_tpu_torch.ops.boxes import wh_iou_matrix
    rng = np.random.default_rng(5)
    wh1 = rng.uniform(0.1, 30, (3, 7, 2)).astype(np.float32)
    wh2 = rng.uniform(0.1, 30, (4, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jax_wh)(wh1, wh2))
    got = wh_iou_matrix(torch.from_numpy(wh1), torch.from_numpy(wh2))
    assert np.abs(got.numpy() - want).max() <= 1e-6


def _heads(v5):
    from rtdm_tpu.models.darknet import YoloHead as JaxHead

    from rtdm_tpu_torch.models.darknet import YoloHead
    anchors = ([[10, 13], [16, 30], [33, 23]], [[30, 61], [62, 45],
                                                 [59, 119]])
    if not v5:
        anchors = anchors[:2]
    return ([JaxHead(np.array(a, np.float32), 2, i, v5=v5)
             for i, a in enumerate(anchors)],
            [YoloHead(np.array(a, np.float32), 2, i, v5=v5)
             for i, a in enumerate(anchors)])


def _loss_batch(rng, img=128):
    """Raw maps for strides 8 and 16 at ``img``, and labels (B, 6, 5) in
    pixels where labels 0 and 1 of image 0 share a cell and an anchor."""
    b, m = 3, 6
    raw = [rng.normal(0, 1.5, (b, img // s, img // s, 21)).astype(np.float32)
           for s in (8, 16)]
    labels = np.zeros((b, m, 5), np.float32)
    labels[..., 0] = rng.integers(0, 2, (b, m))
    labels[..., 1:3] = rng.uniform(4, img - 4, (b, m, 2))
    labels[..., 3:5] = rng.uniform(6, 60, (b, m, 2))
    labels[0, 1, 1:3] = labels[0, 0, 1:3] + 0.5     # one cell, two labels
    labels[0, 1, 3:5] = labels[0, 0, 3:5] * 1.1      # the same anchor
    nlab = np.array([6, 4, 0], np.int32)
    return raw, labels, nlab


def _jax_loss(v5, jheads, raw, labels, nlab, img):
    from rtdm_tpu.train import yolo_loss as jl
    fn = jl.yolo_loss_v5 if v5 else jl.yolo_loss
    hyp = (jl.scale_v5_gains(jl.YoloHypV5(), 2, 2, img) if v5
           else jl.YoloHyp())

    def total(maps):
        loss, comps = fn(maps, jheads, jnp.asarray(labels),
                         jnp.asarray(nlab), img, hyp)
        return loss, comps
    (loss, comps), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [jnp.asarray(r) for r in raw])
    return (float(loss), {k: float(v) for k, v in comps.items()},
            [np.asarray(g) for g in grads])


def _port_loss(v5, heads, raw, labels, nlab, img, loss_fn=None):
    from rtdm_tpu_torch.train import yolo_loss as tl
    fn = loss_fn or (tl.yolo_loss_v5 if v5 else tl.yolo_loss)
    hyp = (tl.scale_v5_gains(tl.YoloHypV5(), 2, 2, img) if v5
           else tl.YoloHyp())
    maps = [torch.from_numpy(r).requires_grad_() for r in raw]
    loss, comps = fn(maps, heads, torch.from_numpy(labels),
                     torch.from_numpy(nlab), img, hyp)
    loss.backward()
    return (float(loss), {k: float(v) for k, v in comps.items()},
            [m.grad.numpy() for m in maps])


@pytest.mark.parametrize("v5", [False, True], ids=["v3", "v5"])
def test_loss_and_gradients_match_jax(v5):
    rng = np.random.default_rng(6)
    raw, labels, nlab = _loss_batch(rng)
    jheads, heads = _heads(v5)
    want_loss, want_comps, want_grads = _jax_loss(v5, jheads, raw, labels,
                                                  nlab, 128)
    got_loss, got_comps, got_grads = _port_loss(v5, heads, raw, labels,
                                                nlab, 128)
    assert abs(got_loss - want_loss) <= LOSS_TOL * abs(want_loss)
    for k in ("box", "obj", "cls"):
        assert abs(got_comps[k] - want_comps[k]) <= \
            LOSS_TOL * abs(want_comps[k]), k
    for g, w in zip(got_grads, want_grads):
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("v5", [False, True], ids=["v3", "v5"])
def test_last_write_wins_control_misses(v5):
    rng = np.random.default_rng(6)
    raw, labels, nlab = _loss_batch(rng)
    jheads, heads = _heads(v5)
    _, want_comps, _ = _jax_loss(v5, jheads, raw, labels, nlab, 128)
    record = {"collisions": 0}
    _, got_comps, _ = _port_loss(v5, heads, raw, labels, nlab, 128,
                                 loss_fn=chip_smoke._lww_loss(v5, record))
    assert record["collisions"] > 0
    assert abs(got_comps["obj"] - want_comps["obj"]) > \
        LOSS_TOL * abs(want_comps["obj"])


def test_raw_to_train_layout_matches_jax():
    from rtdm_tpu.ops.yolo import raw_to_train_layout as jax_layout

    from rtdm_tpu_torch.ops.yolo import raw_to_train_layout
    x = np.random.default_rng(7).normal(size=(2, 5, 6, 21)).astype(
        np.float32)
    np.testing.assert_array_equal(
        raw_to_train_layout(torch.from_numpy(x), 3, 2).numpy(),
        np.asarray(jax_layout(jnp.asarray(x), 3, 2)))


def test_ema_matches_jax():
    from rtdm_tpu.train.ema import ema_init as jax_init
    from rtdm_tpu.train.ema import ema_update as jax_update

    from rtdm_tpu_torch.models.io import (flatten_tree,
                                          variables_from_torch_state_dict)
    from rtdm_tpu_torch.train.ema import ema_init, ema_update
    rng = np.random.default_rng(8)
    _, variables, model = _darknet_pair(rng)
    ema = ema_init(model)
    jema = jax_init(variables)
    upd = jax.jit(jax_update)
    for step in range(5):
        with torch.no_grad():
            for t in model.state_dict().values():
                t.add_(torch.from_numpy(rng.normal(
                    0, 0.1, tuple(t.shape)).astype(np.float32)))
        ema_update(ema, model, step)
        # copies: the arrays share the model's memory, which the next
        # step changes in place while JAX's asynchronous dispatch may
        # still be reading them
        current = jax.tree_util.tree_map(
            np.copy, variables_from_torch_state_dict(model.state_dict()))
        jema = upd(jema, current, jnp.asarray(step, jnp.int32))
    got = flatten_tree(variables_from_torch_state_dict(ema))
    want = flatten_tree(jax.device_get(jema))
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            1e-6 * np.abs(want[k]).max(), k
