"""The four data CLIs against the JAX package's, on one temporary tree.

``create_splits`` (stratified 70/20/10 from seed 42, the optional plot),
``gen_txts`` (absolute and relative lists), ``img_verify`` (scan, then
``--delete``) and ``log_dataset`` (the manifest, its artifact file and the
run log's events) are each run in both packages on the same inputs; their
return values and the files they write are equal.
"""

import csv
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rtdm_tpu_torch.data.example_set import write_example_set

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A labels CSV of five unequal classes, an image directory with
    mixed suffixes, corrupt files and a non-image, and the example set."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    rows = [(f"aider/{c}/img_{i}.jpg", c) for c in range(5)
            for i in range(int(rng.integers(7, 40)))]
    with open(root / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    imgs = root / "images"
    (imgs / "sub").mkdir(parents=True)
    for name in ("b.jpg", "a.png", "d.JPG", "e.jpeg", "f.bmp",
                 "sub/g.jpg"):
        img = rng.integers(0, 256, (12, 16, 3), np.uint8)
        Image.fromarray(img).save(imgs / name)
    (imgs / "c.txt").write_text("not an image")
    good = (imgs / "b.jpg").read_bytes()
    (imgs / "bad.jpg").write_bytes(good[:20])
    (imgs / "sub" / "bad2.png").write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    data = write_example_set(root / "set", jpeg=True)
    return root, data


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("argv", [[], ["--seed", "7", "--prefix", "x"],
                                  ["--ratios", "0.6", "0.3", "0.1"]])
def test_create_splits_matches_jax(tree, tmp_path, argv):
    from rtdm_tpu.cli.create_splits import main as jax_main

    from rtdm_tpu_torch.cli.create_splits import main
    root, _ = tree
    got = main(["--labels", str(root / "labels.csv"), "--output-dir",
                str(tmp_path / "port")] + argv)
    want = jax_main(["--labels", str(root / "labels.csv"), "--output-dir",
                     str(tmp_path / "jax")] + argv)
    assert got == want
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert len(_files(tmp_path / "port")) == 3


def test_create_splits_plot_and_lazy_matplotlib(tree, tmp_path):
    from rtdm_tpu_torch.cli.create_splits import main
    root, _ = tree
    main(["--labels", str(root / "labels.csv"), "--output-dir",
          str(tmp_path), "--plot"])
    assert (tmp_path / "class_distribution.png").stat().st_size > 0
    code = ("import sys, rtdm_tpu_torch.cli.create_splits; "
            "sys.exit('matplotlib' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          timeout=120).returncode == 0


@pytest.mark.parametrize("relative", [False, True])
def test_gen_txts_matches_jax(tree, tmp_path, relative):
    from rtdm_tpu.cli.gen_txts import main as jax_main

    from rtdm_tpu_torch.cli.gen_txts import main
    root, _ = tree
    extra = ["--relative-to", str(root)] if relative else []
    got = main(["--images", str(root / "images"), "--output",
                str(tmp_path / "port.txt")] + extra)
    want = jax_main(["--images", str(root / "images"), "--output",
                     str(tmp_path / "jax.txt")] + extra)
    assert got == want and len(got) == 6
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()


def test_img_verify_matches_jax(tree, tmp_path, capsys):
    from rtdm_tpu.cli.img_verify import main as jax_main

    from rtdm_tpu_torch.cli.img_verify import main
    root, _ = tree
    for name in ("port", "jax"):
        shutil.copytree(root / "images", tmp_path / name)
    run = {"port": main, "jax": jax_main}
    found = {k: run[k](["--root", str(tmp_path / k)]) for k in run}
    rel = {k: sorted(str(Path(p).relative_to(tmp_path / k)) for p in v)
           for k, v in found.items()}
    assert rel["port"] == rel["jax"] == ["bad.jpg", "sub/bad2.png"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    deleted = {k: run[k](["--root", str(tmp_path / k), "--delete"])
               for k in run}
    assert [Path(p).name for p in deleted["port"]] == \
        [Path(p).name for p in deleted["jax"]]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert not (tmp_path / "port" / "bad.jpg").exists()
    out = capsys.readouterr().out
    assert out.count("scanned 8 images, 2 corrupt\n") == 2
    assert out.count("scanned 8 images, 2 corrupt (deleted)") == 2


def test_log_dataset_matches_jax(tree, tmp_path):
    from rtdm_tpu.cli.log_dataset import main as jax_main

    from rtdm_tpu_torch.cli.log_dataset import main
    _, data = tree
    got = main(["--data", data, "--project", str(tmp_path / "port")])
    want = jax_main(["--data", data, "--project", str(tmp_path / "jax")])
    assert got == want
    assert got["splits"]["valid"]["images"] == 10
    assert got["splits"]["valid"]["labelled"] == 10
    assert len(got["fingerprint"]) == 16
    art = "examples-artifact.json"
    assert json.loads((tmp_path / "port" / art).read_text()) == \
        json.loads((tmp_path / "jax" / art).read_text())

    def events(d):
        with open(d / "dataset.jsonl") as f:
            recs = [json.loads(line) for line in f]
        return [{k: v for k, v in r.items() if k not in ("t", "run_id")}
                for r in recs]
    port, jax = events(tmp_path / "port"), events(tmp_path / "jax")
    assert [r["event"] for r in port] == ["config", "artifact"]
    assert port[0] == jax[0]
    assert Path(port[1].pop("path")).relative_to(tmp_path / "port") == \
        Path(jax[1].pop("path")).relative_to(tmp_path / "jax")
    assert port[1] == jax[1]


def test_log_dataset_single_cls_matches_jax(tree, tmp_path):
    from rtdm_tpu.cli.log_dataset import build_manifest as jax_manifest

    from rtdm_tpu_torch.cli.log_dataset import build_manifest
    _, data = tree
    got = build_manifest(data, single_cls=True)
    assert got == jax_manifest(data, single_cls=True)
    assert got["nc"] == 1
