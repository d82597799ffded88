"""The port's classifier training CLI end to end on the CPU, and its data
side against the JAX package.

- ``train_model`` on an AIDER-style directory whose five classes are five
  hues (the fixture of ``tests/test_cli.py``), fp32, 4 epochs: the train
  loss falls, validation accuracy reaches 0.4, ``last``/``best`` and the
  final ``.npz`` are written; the ``.npz`` loads in the JAX package's
  ``load_variables`` and both packages' fp32 engines give its logits
  within the fp32 engine gate (1e-4 of max |logit|,
  ``tests/test_torch_engine.py``). A bf16 run with the albumentations
  augmentations and mixup/cutmix resumes from its ``last`` checkpoint.
- ``AiderDataset(train=True)`` samples and ``BatchLoader`` batches equal the
  JAX package's bit for bit in both augmentation styles, over enough
  samples that every branch of the transforms runs (counted).
- ``parse_args`` takes the JAX CLI's flags into the same config; a
  ``config.json`` written by either package loads in the other; a
  ``--pretrained`` ``.npz`` or reference ``.pt`` starts the model.
"""

import csv
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from rtdm_tpu_torch.cli import aider_train
from rtdm_tpu_torch.core.config import TrainingConfig
from rtdm_tpu_torch.data import aider as port_aider

ENGINE_TOL = 1e-4     # the fp32 engine gate (tests/test_torch_engine.py)


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _write_split(root, rows, name):
    with open(root / name, "w", newline="") as f:
        csv.writer(f).writerows(rows)


@pytest.fixture(scope="module")
def aider_dir(tmp_path_factory):
    """AIDER-style dir: 40 images of 160x160, 5 classes, each a hue."""
    root = tmp_path_factory.mktemp("aider_port")
    rng = np.random.default_rng(0)
    colors = [(200, 30, 30), (30, 200, 30), (30, 30, 200),
              (200, 200, 30), (30, 200, 200)]
    rows = []
    for i in range(40):
        label = i % 5
        base = np.array(colors[label], np.uint8)
        arr = np.clip(base[None, None] + rng.normal(0, 25, (160, 160, 3)),
                      0, 255).astype(np.uint8)
        rel = f"img_{i}.jpg"
        Image.fromarray(arr).save(root / rel)
        rows.append((rel, label))
    _write_split(root, rows[:30], "train.csv")
    _write_split(root, rows[30:35], "val.csv")
    _write_split(root, rows[35:], "test.csv")
    return root


def _config(aider_dir, out, **kw):
    base = dict(model="squeeze-ernet", batch_size=5, epochs=4, lr=3e-3,
                grad_accum_steps=1, precision="fp32", augment=False,
                early_stopping=False, num_workers=2,
                root_dir=str(aider_dir),
                train_split=str(aider_dir / "train.csv"),
                val_split=str(aider_dir / "val.csv"),
                test_split=str(aider_dir / "test.csv"),
                checkpoint_dir=str(out / "saves"), log_dir=str(out / "logs"),
                device="cpu")
    base.update(kw)
    return TrainingConfig(**base)


@pytest.fixture(scope="module")
def trained(aider_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    config = _config(aider_dir, out)
    state, history = aider_train.train_model(config)
    return config, state, history


def test_training_learns_and_writes(trained):
    config, state, history = trained
    assert len(history["train_loss"]) == 4
    assert history["train_loss"][-1] < history["train_loss"][0]
    assert max(history["val_acc"]) >= 0.4
    import os
    for tag in ("last", "best"):
        assert os.path.isfile(os.path.join(config.checkpoint_dir,
                                           f"{tag}.pt"))
        assert os.path.isfile(os.path.join(config.checkpoint_dir,
                                           f"{tag}.meta.json"))
    assert os.path.isfile(config.weights)
    assert os.path.isfile(os.path.join(config.log_dir, "config.json"))
    assert state.step == 4 * 3


def test_weights_serve_in_both_engines(trained, aider_dir):
    from rtdm_tpu.export.engine import build_engine as jax_build_engine
    from rtdm_tpu.models.io import load_variables as jax_load_variables
    from rtdm_tpu_torch.export.engine import build_engine
    from rtdm_tpu_torch.models.io import load_variables

    config, _, _ = trained
    frames = np.stack([port_aider.AiderDataset(
        aider_dir / "test.csv", aider_dir).load(i)[0] for i in range(5)])
    want = jax_build_engine("squeeze-ernet", jax_load_variables(
        config.weights), "fp32", batch_size=8)(frames)
    got = build_engine("squeeze-ernet", load_variables(config.weights),
                       "fp32", batch_size=8, device="cpu")(frames)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ENGINE_TOL * np.abs(want).max())


def test_bf16_augmented_run_resumes(aider_dir, tmp_path):
    config = _config(aider_dir, tmp_path, epochs=1, precision="bf16",
                     augment=True, batch_size=10, grad_accum_steps=2,
                     save_best_only=True)
    _, history = aider_train.train_model(config)
    assert len(history["train_loss"]) == 1
    assert np.isfinite(history["train_loss"]).all()
    resumed = dataclasses.replace(config, epochs=2, resume=True)
    state, history = aider_train.train_model(resumed)
    assert resumed.checkpoint_dir == config.checkpoint_dir
    assert len(history["train_loss"]) == 2 and state.step == 2
    assert np.isfinite(history["val_loss"]).all()


def test_cuda_by_default_and_pt_pretrained_raises(aider_dir, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            aider_train.train_model(_config(aider_dir, tmp_path,
                                            device="cuda"))
    from rtdm_tpu_torch.models.io import load_variables
    from tests.torch_checkpoints import save_classifier_pt
    engines = __import__("pathlib").Path(__file__).resolve().parents[1] / \
        "artifacts" / "engines"
    start = load_variables(str(engines / "squeeze-ernet_bf16" / "params.npz"))
    config = _config(aider_dir, tmp_path, pretrained=True, epochs=1,
                     weights=save_classifier_pt(tmp_path / "w.pt", start,
                                                "state_dict"))
    state, history = aider_train.train_model(config)
    assert len(history["train_loss"]) == 1 and state.step == 3
    assert np.isfinite(history["train_loss"]).all()


def test_summary_counts_the_parameters(capsys):
    aider_train.main(["--summary", "--model", "squeeze-ernet"])
    assert "169,241" in capsys.readouterr().out


class _Count:
    """Counts the calls of the transforms' module-level helpers, so that
    the test knows every branch ran."""

    def __init__(self, monkeypatch, names):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(port_aider, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.n[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(port_aider, name, wrapped)


def _image(rng):
    h, w = rng.integers(40, 90, 2)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))


@pytest.mark.parametrize("style", ["albumentations", "torchvision"])
def test_train_transforms_equal_jax(monkeypatch, tmp_path, style):
    from rtdm_tpu.data.aider import AiderDataset as JaxDataset
    split = tmp_path / "s.csv"
    split.write_text("")
    jds = JaxDataset(split, tmp_path, 32, train=True, aug_style=style)
    pds = port_aider.AiderDataset(split, tmp_path, 32, train=True,
                                  aug_style=style)
    helpers = (["_random_blur", "_clahe", "_hsv_jitter",
                "_optical_distortion", "_grid_distortion",
                "_elastic_transform"] if style == "albumentations"
               else ["_color_jitter"])
    counts = _Count(monkeypatch, helpers)
    jtf = (jds._train_transform if style == "albumentations"
           else jds._train_transform_tv)
    ptf = (pds._train_transform if style == "albumentations"
           else pds._train_transform_tv)
    img_rng = np.random.default_rng(1)
    for seed in range(400):
        img = _image(img_rng)
        want = jtf(img, np.random.default_rng(seed))
        got = ptf(img, np.random.default_rng(seed))
        assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, want)
    assert all(counts.n.values()), counts.n


@pytest.mark.parametrize("style", ["albumentations", "torchvision"])
def test_train_batches_equal_jax(aider_dir, style):
    from rtdm_tpu.data.aider import AiderDataset as JaxDataset
    from rtdm_tpu.data.aider import BatchLoader as JaxLoader
    split = aider_dir / "train.csv"
    loaders = [
        cls_l(cls_d(split, aider_dir, 64, train=True, seed=3,
                    aug_style=style), 8, shuffle=True, drop_last=True,
              num_workers=2, seed=5)
        for cls_d, cls_l in ((JaxDataset, JaxLoader),
                             (port_aider.AiderDataset,
                              port_aider.BatchLoader))]
    for _ in range(2):      # two epochs: the order moves with the epoch
        batches = [list(loader) for loader in loaders]
        assert len(batches[0]) == len(batches[1]) == 3
        for (ji, jl, jv), (pi, pl, pv) in zip(*batches):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pl, jl)
            assert pv == jv == 8
    ds = port_aider.AiderDataset(split, aider_dir, 64)
    np.testing.assert_array_equal(
        ds.class_weights(), np.full(5, 0.2, np.float32))


def test_parse_args_takes_the_jax_flags():
    from rtdm_tpu.cli.aider_train import parse_args as jax_parse_args
    argv = ["--model", "ernet", "--loss", "focal", "--optimizer", "sgd",
            "--scheduler", "cosine", "--root-dir", "r", "--train-split",
            "a.csv", "--val-split", "b.csv", "--test-split", "c.csv",
            "--batch-size", "12", "--epochs", "7", "--lr", "0.01",
            "--weight-decay", "0.001", "--label-smoothing", "0.2",
            "--grad-clip", "2", "--grad-accum-steps", "3",
            "--warmup-ratio", "0.2", "--precision", "fp32", "--patience",
            "4", "--no-early-stopping", "--no-augment", "--mixup-alpha",
            "0.3", "--cutmix-alpha", "0.4", "--num-workers", "3",
            "--checkpoint-dir", "ck", "--log-dir", "lg", "--resume",
            "--seed", "9", "--weights", "w.npz", "--pretrained",
            "--min-lr", "1e-5", "--momentum", "0.8", "--warmup-epochs", "2",
            "--dropout", "0.1", "--image-size", "200", "--checkpoint-freq",
            "2", "--save-best-only", "--no-albumentations", "--no-amp",
            "--no-pin-memory"]
    want = dataclasses.asdict(jax_parse_args(argv))
    got = dataclasses.asdict(aider_train.parse_args(argv + ["--device",
                                                            "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    assert aider_train.parse_args([]).device == "cuda"


def test_pretrained_npz_starts_the_model(trained):
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.models.io import (load_variables,
                                          torch_state_dict_from_variables)
    config, _, _ = trained
    model = create_model("squeeze-ernet", device="cpu")
    aider_train._load_pretrained(model, config.weights)
    want = torch_state_dict_from_variables(load_variables(config.weights))
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_config_files_load_in_both_packages(tmp_path):
    from rtdm_tpu.core.config import TrainingConfig as JaxConfig
    port = TrainingConfig(model="squeeze-ernet", batch_size=16, device="cpu",
                          mesh_shape=(2,))
    path = port.save(str(tmp_path / "port.json"))
    again = TrainingConfig.load(path)
    assert again == port and again.batch_size == 32     # doubled once
    jax_view = dataclasses.asdict(JaxConfig.load(path))
    want = dataclasses.asdict(port)
    want.pop("device")
    assert jax_view == want
    jpath = JaxConfig(model="ernet", lr=0.1).save(str(tmp_path / "jax.json"))
    loaded = TrainingConfig.load(jpath)
    assert loaded.device == "cuda" and loaded.lr == 0.1
    assert loaded.batch_size == 32 and loaded.image_size == 240
