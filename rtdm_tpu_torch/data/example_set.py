"""The labelled example set: ``docs/examples`` as a darknet detection set.

``docs/examples/*.jpg`` are ten aerial frames and ``*.txt`` the trained
yolov4-tiny's own detections on them at conf 0.4 (``name conf x1 y1 x2 y2``
in original-image pixels; ``docs/examples/README.md``). ``write_example_set``
writes them as a set ``yolo_test`` reads: the frames decoded by PIL and
saved as ``.png``, the pixels the committed goldens were computed on (a
``.jpg`` would take the native libjpeg decode, alike in both packages, and
other pixels than PIL's), one YOLO label row a detection
(``cls cx cy w h``, normalised, clipped to the frame), a ``valid.txt``
list and a darknet ``.data`` with the names person and vehicle. These
labels are no ground truth: a model scored on them reports how far it
reproduces those detections, which makes a port that loses detections
show. Shared by the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

EXAMPLES = Path(__file__).resolve().parents[2] / "docs" / "examples"
NAMES = ("person", "vehicle")


def write_example_set(out_dir, examples: Path = EXAMPLES,
                      jpeg: bool = False) -> str:
    """Write the set under ``out_dir`` (``images/*.png``, ``labels/*.txt``,
    ``valid.txt``, ``data/examples.{data,names}``); returns the ``.data``
    path. With ``jpeg`` the images are the example JPEGs themselves,
    copied byte for byte (``images/*.jpg``), for the native decode."""
    import shutil

    from PIL import Image

    out = Path(out_dir)
    for sub in ("images", "labels", "data"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    listed = []
    for jpg in sorted(Path(examples).glob("*.jpg")):
        with Image.open(jpg) as im:
            img = np.asarray(im.convert("RGB"), np.uint8)
        image = f"images/{jpg.stem}{'.jpg' if jpeg else '.png'}"
        if jpeg:
            shutil.copyfile(jpg, out / image)
        else:
            Image.fromarray(img).save(out / image)
        h, w = img.shape[:2]
        rows = []
        for line in jpg.with_suffix(".txt").read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            x1, y1, x2, y2 = (float(v) for v in parts[2:6])
            x1, x2 = np.clip([x1, x2], 0, w)
            y1, y2 = np.clip([y1, y2], 0, h)
            rows.append(f"{NAMES.index(parts[0])} {(x1 + x2) / 2 / w:.6f} "
                        f"{(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} "
                        f"{(y2 - y1) / h:.6f}")
        (out / "labels" / f"{jpg.stem}.txt").write_text(
            "".join(r + "\n" for r in rows))
        listed.append(image)
    (out / "valid.txt").write_text("".join(p + "\n" for p in listed))
    (out / "data" / "examples.names").write_text(
        "".join(n + "\n" for n in NAMES))
    data = out / "data" / "examples.data"
    data.write_text(f"classes={len(NAMES)}\ntrain=valid.txt\n"
                    f"valid=valid.txt\nnames=data/examples.names\n")
    return str(data)


def write_engine_as_cfg(engine_dir, out_dir) -> tuple:
    """A committed detector engine as ``yolo_test`` takes it (``--cfg`` and
    ``--weights``): its ``model.txt`` (the fused cfg, or the v5 yaml with
    ``nc`` set to the engine's classes) written to ``<name>.cfg`` or
    ``<name>.yaml``, and its weights, dequantized (a sealed kernel loads as
    q * s), to ``<name>.npz``. Returns (cfg path, weights path)."""
    import json
    import re

    from rtdm_tpu_torch.models.io import load_variables, save_variables

    engine_dir, out = Path(engine_dir), Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    spec = json.loads((engine_dir / "spec.json").read_text())
    suffix = ".yaml" if spec.get("family") == "yolov5" else ".cfg"
    cfg = out / f"{engine_dir.name}{suffix}"
    text = (engine_dir / "model.txt").read_text()
    if spec.get("num_classes") is not None:
        text = re.sub(r"^nc:\s*\d+", f"nc: {spec['num_classes']}", text,
                      flags=re.M)
    cfg.write_text(text)
    weights = out / f"{engine_dir.name}.npz"
    save_variables(str(weights),
                   load_variables(str(engine_dir / "params.npz")))
    return str(cfg), str(weights)
