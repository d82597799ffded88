"""The detector trainer's host-side kernels and its optimizers against the
JAX package:

- ``train/autoanchor.py`` (the label wh with its jitter, BPR, fitness,
  k-means and the genetic evolution, ``check_anchors``,
  ``check_anchor_order``) and ``train/evolve.py`` (fitness,
  ``select_parent``, ``mutate``, ``EvolveLog``): bit-equal, draw for draw;
- ``utils/yaml_io.py`` against PyYAML: the model yamls, a hyp file and
  the files the trainer writes read alike; what it writes reads back equal
  in both;
- ``train/schedules.py``'s YOLO optimizers against the optax chains of
  ``rtdm_tpu/cli/yolo_train.py`` (``tests/torch_port_goldens.py::
  jax_yolo_optimizer``) over 20 updates of seeded gradients on a narrow
  darknet model's parameters, each family: v3 nesterov SGD with burn-in
  and cosine, v3 Adam (optax's ``adamw`` with the kernel mask), v5 SGD
  with the warm-up groups and the momentum ramp, v5 Adam (L2 first), the
  v5 linear lr, and the prebias SGD: every parameter within ``OPT_TOL``
  (1e-6) of its max |value| for SGD, ``ADAM_TOL`` (2e-5) for Adam (read:
  7e-6 in both Adam families; optax's fp32 Adam is itself 7.6e-7 from
  float64 after these 20 updates of a unit-scale vector, torch's 2.0e-7);
  the clip is active in the first updates;
- ``plot_detector_results`` and ``plot_evolution_results`` draw their PNGs.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

OPT_TOL = 1e-6
ADAM_TOL = 2e-5
OPT_STEPS = 20

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

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58
classes=2
"""


class _Labels:
    """A stand-in dataset: labels only, no image paths (square frames)."""

    def __init__(self, labels):
        self.labels = labels

    def __len__(self):
        return len(self.labels)


def _label_sets(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 6))
        lab = np.zeros((k, 5), np.float32)
        lab[:, 0] = rng.integers(0, 2, k)
        lab[:, 1:3] = rng.uniform(0.2, 0.8, (k, 2))
        lab[:, 3:5] = rng.uniform(0.01, 0.5, (k, 2))
        out.append(lab)
    return out


def test_autoanchor_is_bit_equal():
    from rtdm_tpu.train import autoanchor as ja

    from rtdm_tpu_torch.train import autoanchor as ta
    ds = _Labels(_label_sets(0))
    for jitter in (True, False):
        np.testing.assert_array_equal(
            ta.collect_label_wh(ds, 416, jitter, seed=3),
            ja.collect_label_wh(ds, 416, jitter, seed=3))
    wh = ta.collect_label_wh(ds, 416)
    anchors = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                        [59, 119]], np.float32)
    assert ta.anchor_fitness(anchors, wh) == ja.anchor_fitness(anchors, wh)
    assert ta.best_possible_recall(anchors, wh) == \
        ja.best_possible_recall(anchors, wh)
    np.testing.assert_array_equal(
        ta.kmean_anchors(wh, 6, 416, gen=200, seed=1),
        ja.kmean_anchors(wh, 6, 416, gen=200, seed=1))
    for apx in (anchors.reshape(2, 3, 2), anchors.reshape(2, 3, 2) * 8):
        got = ta.check_anchors(ds, apx, 416, gen=100)
        want = ja.check_anchors(ds, apx, 416, gen=100)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    desc = anchors.reshape(2, 3, 2)[::-1]
    np.testing.assert_array_equal(ta.check_anchor_order(desc),
                                  ja.check_anchor_order(desc))


def test_evolve_kernels_are_bit_equal(tmp_path):
    from rtdm_tpu.train import evolve as je

    from rtdm_tpu_torch.train import evolve as te
    for meta, w in ((te.V5_EVOLVE_META, te.FITNESS_W_V5),
                    (te.V3_EVOLVE_META, te.FITNESS_W_V3)):
        assert meta == (je.V5_EVOLVE_META if meta is te.V5_EVOLVE_META
                        else je.V3_EVOLVE_META)
        rng = np.random.default_rng(5)
        rows = np.c_[rng.uniform(0, 1, (7, 7)),
                     rng.uniform(0.01, 1, (7, len(meta)))]
        np.testing.assert_array_equal(te.fitness(rows, w),
                                      je.fitness(rows, w))
        for parent in ("single", "weighted"):
            for seed in range(3):
                np.testing.assert_array_equal(
                    te.select_parent(rows, np.random.default_rng(seed),
                                     parent=parent, w_fit=w),
                    je.select_parent(rows, np.random.default_rng(seed),
                                     parent=parent, w_fit=w))
        genes = {k: float(rows[0, 7 + i]) for i, k in enumerate(meta)}
        for seed in range(3):
            assert te.mutate(genes, meta, np.random.default_rng(seed)) == \
                je.mutate(genes, meta, np.random.default_rng(seed))
        logs = [m.EvolveLog(str(tmp_path / f"{m.__name__}{len(meta)}.txt"),
                            meta, w) for m in (te, je)]
        for i in range(4):
            hyp = te.mutate(genes, meta, np.random.default_rng(i))
            for log in logs:
                log.append(hyp, list(rows[i, :7]))
        np.testing.assert_array_equal(logs[0].load(), logs[1].load())
        assert logs[0].best() == logs[1].best()
        import yaml
        for log, name in zip(logs, ("port", "jax")):
            log.save_yaml(str(tmp_path / f"{name}.yaml"))
        assert yaml.safe_load((tmp_path / "port.yaml").read_text()) == \
            yaml.safe_load((tmp_path / "jax.yaml").read_text())


def test_yaml_io_reads_and_writes_as_pyyaml(tmp_path):
    import yaml

    from rtdm_tpu_torch.utils import yaml_io
    from tests.torch_port_goldens import ROOT
    texts = [(ROOT / "artifacts" / "engines" / "yolov5s-mini_int8" /
              "model.txt").read_text(),
             "# hyp\nlr0: 0.01  # initial\nlrf: 0.2\nmomentum: 0.937\n"
             "fliplr: 0.5\nname: 'x # y'\nflag: true\nnone: null\n"
             "names: ['victim', 'vehicle']\nsmall: 1.0e-05\n"]
    for text in texts:
        assert yaml_io.loads(text) == yaml.safe_load(text)
    values = {"lr0": 1e-05, "lrf": 0.2, "n": 3, "s": "it's", "neg": -0.5,
              "big": 12345678.9, "lists": [[1, 2.5], [None, True, "a b"]],
              "inf": float("inf")}
    for sort_keys in (True, False):
        text = yaml_io.dumps(values, sort_keys)
        assert yaml.safe_load(text) == values == yaml_io.loads(text)
    assert list(yaml_io.loads(yaml_io.dumps(values, False))) == list(values)


def _narrow_models():
    from rtdm_tpu.models.darknet import Darknet as JaxDarknet

    from rtdm_tpu_torch.models.darknet import Darknet
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    variables = JaxDarknet(cfg_text=DARKNET_CFG).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    model = Darknet(DARKNET_CFG)
    model.load_state_dict(torch_state_dict_from_variables(variables))
    return jax.device_get(variables["params"]), model


def _grads(params, rng, scale):
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(0, scale, p.shape)).astype(np.float32), params)


@pytest.mark.parametrize("family,optimizer,extra", [
    ("v3", "sgd", []), ("v3", "adam", []), ("v5", "sgd", []),
    ("v5", "adam", []), ("v5", "sgd", ["--linear-lr"]),
    ("prebias", "sgd", [])])
def test_optimizers_match_optax(family, optimizer, extra):
    import optax

    from rtdm_tpu_torch.cli.yolo_train import head_bias_names, parse_args
    from rtdm_tpu_torch.models.io import (flatten_tree,
                                          torch_state_dict_from_variables,
                                          variables_from_torch_state_dict)
    from rtdm_tpu_torch.train.schedules import (make_prebias_optimizer,
                                                make_yolo_optimizer)
    from tests.torch_port_goldens import jax_yolo_optimizer
    params, model = _narrow_models()
    args = parse_args(["--cfg", "x.yaml" if family == "v5" else "x.cfg",
                       "--optimizer", optimizer, "--lr0", "0.01",
                       "--momentum", "0.9", "--weight-decay", "0.05",
                       "--burn-in", "5"] + extra)
    total, per_epoch = 60, 4
    if family == "prebias":
        heads = head_bias_names(model)
        tx = optax.chain(
            optax.clip_by_global_norm(10.0),
            optax.masked(optax.sgd(0.01, momentum=0.9),
                         lambda p: {k: {n: n == "bias" and
                                        f"{k}.bias" in heads for n in v}
                                    for k, v in p.items()}),
            optax.masked(optax.set_to_zero(),
                         lambda p: {k: {n: not (n == "bias" and
                                             f"{k}.bias" in heads)
                                        for n in v} for k, v in p.items()}))
        opt = make_prebias_optimizer(model, heads)
    else:
        tx = jax_yolo_optimizer(args, family == "v5", per_epoch, total)
        opt = make_yolo_optimizer(model, family == "v5", optimizer, 0.01,
                                  0.9, 0.05, total, burn_in=5,
                                  linear_lr="--linear-lr" in extra,
                                  steps_per_epoch=per_epoch)
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(9)
    named = dict(model.named_parameters())
    for k in range(OPT_STEPS):
        grads = _grads(params, rng, 20.0 if k < 3 else 0.5)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        as_torch = torch_state_dict_from_variables({"params": grads})
        for name, p in named.items():
            p.grad = as_torch[name].clone()
        opt.step()
    got = flatten_tree(variables_from_torch_state_dict(
        dict(model.named_parameters())))
    want = flatten_tree({"params": jax.device_get(params)})
    assert opt.count == OPT_STEPS
    tol = ADAM_TOL if optimizer == "adam" else OPT_TOL
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            tol * np.abs(want[k]).max(), k


def test_plots_draw(tmp_path):
    from rtdm_tpu_torch.train.evolve import EvolveLog, V5_EVOLVE_META
    from rtdm_tpu_torch.utils.plots import (plot_detector_results,
                                            plot_evolution_results)
    results = tmp_path / "results.txt"
    results.write_text(
        "epoch 1/2 box 0.9 obj 0.4 cls 2.0 1.0s | P 0.100 R 0.200 "
        "mAP@0.5 0.050\nepoch 2/2 box 0.8 obj 0.3 cls 1.5 1.0s\n")
    assert plot_detector_results(str(results), str(tmp_path / "r.png"))
    log = EvolveLog(str(tmp_path / "evolve.txt"), V5_EVOLVE_META)
    rng = np.random.default_rng(0)
    for i in range(3):
        log.append({k: float(rng.uniform(0.1, 0.5)) for k in V5_EVOLVE_META},
                   list(rng.uniform(0, 1, 7)))
    plot_evolution_results(log.path, str(tmp_path / "e.png"),
                           keys=list(V5_EVOLVE_META))
    assert (tmp_path / "r.png").stat().st_size and \
        (tmp_path / "e.png").stat().st_size


def test_parse_args_has_every_reference_flag():
    from rtdm_tpu.cli.yolo_train import parse_args as jax_parse

    from rtdm_tpu_torch.cli.yolo_train import parse_args
    argv = ["--cfg", "m.cfg", "--adam", "--workers", "3", "--project", "p",
            "--name", "n"]
    want = vars(jax_parse(argv))
    got = vars(parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert isinstance(argparse.Namespace(**got), argparse.Namespace)
