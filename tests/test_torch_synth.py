"""``data/synth.py`` and ``cli/make_synth.py`` against the JAX package:
from one seed, the generated detection and classification images and
labels are equal before encoding (draw for draw), and the written sets
(image lists, label files, the ``.data`` and ``.yaml``, the CSV splits)
hold the same content, the images decoding to equal arrays (one PIL
encoder here)."""

import numpy as np
import pytest


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generated_arrays_are_bit_equal(seed):
    from rtdm_tpu.data import synth as js

    from rtdm_tpu_torch.data import synth as ts
    assert ts.DET_CLASS_NAMES == js.DET_CLASS_NAMES
    assert ts.DET_SIZES == js.DET_SIZES
    for w, h in ts.DET_SIZES[seed::3]:
        got = ts.make_detection_image(np.random.default_rng(seed), w, h)
        want = js.make_detection_image(np.random.default_rng(seed), w, h)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for label in range(5):
        np.testing.assert_array_equal(
            ts.make_classification_image(np.random.default_rng(seed), label,
                                         90, 70),
            js.make_classification_image(np.random.default_rng(seed), label,
                                         90, 70))


def _tree(root):
    """{relative path: content} of a written set; images decoded, paths
    inside the lists made relative to ``root``."""
    from PIL import Image
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_dir():
            continue
        rel = str(p.relative_to(root))
        if p.suffix == ".jpg":
            with Image.open(p) as im:
                out[rel] = np.asarray(im)
        else:
            out[rel] = p.read_text().replace(str(root.resolve()), "<root>")
    return out


def test_make_synth_writes_the_same_sets(tmp_path):
    from rtdm_tpu.cli.make_synth import main as jax_main

    from rtdm_tpu_torch.cli.make_synth import main
    argv = ["--det-train", "4", "--det-val", "2", "--cls-per-class", "2",
            "--cls-val-per-class", "1", "--cls-test-per-class", "1",
            "--seed", "7"]
    got = main(["--out", str(tmp_path / "port")] + argv)
    jax_main(["--out", str(tmp_path / "jax")] + argv)
    assert set(got) == {"det_data", "det_yaml", "cls_root"}
    a, b = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
