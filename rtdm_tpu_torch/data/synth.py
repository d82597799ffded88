"""Procedural synthetic datasets for training at the scale of the
reference's.

Counterpart of ``rtdm_tpu/data/synth.py``, in numpy and PIL, draw for draw
from one ``np.random.default_rng(seed)``: the same seed gives the same
arrays and labels in both packages (the files may differ only by the JPEG
encoder). The reference trained on AIDER (6,433 aerial scenes) and a
4,502-image ODDER detection set; neither ships in the repo, so these sets
have their shape: the class counts, the file layouts (a darknet ``.data``
and YOLO label txts for detection, CSV splits for classification), mixed
native image sizes (rect buckets, the letterbox and the no-upscale eval cap
all get exercised) and exact procedural labels.

Detection has ODDER's 2 classes: class 0 ("victim"), filled ellipses in a
warm tone, and class 1 ("vehicle"), rotated filled boxes in saturated
colours, over textured backgrounds with unlabelled distractors.
Classification has AIDER's five scenes (the port's ``data/aider.py``
``CLASS_NAMES``), each a procedural texture.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rtdm_tpu_torch.data.aider import CLASS_NAMES as AIDER_CLASS_NAMES

DET_CLASS_NAMES = ("victim", "vehicle")

# native sizes: mixed aspect ratios so --rect produces several AR buckets
# and some images are smaller than the 416 train size (exercising the
# upscale/no-upscale eval split, odder.py eval_scaleup)
DET_SIZES = ((640, 480), (480, 640), (512, 384), (640, 640), (544, 416),
             (416, 736), (800, 600), (352, 288))


def _background(rng: np.random.Generator, h: int, w: int,
                base: Sequence[int], var: int = 40) -> np.ndarray:
    """Low-frequency color field + fine noise — enough texture that a
    constant-color prior can't solve the task."""
    from PIL import Image

    grid = rng.integers(-var, var + 1, (6, 6, 3)).astype(np.float32)
    low = np.asarray(Image.fromarray(
        np.clip(np.array(base, np.float32) + grid, 0, 255).astype(np.uint8)
    ).resize((w, h), Image.BILINEAR), np.float32)
    noise = rng.normal(0.0, 6.0, (h, w, 1)).astype(np.float32)
    return np.clip(low + noise, 0, 255).astype(np.uint8)


def _rot_box(cx: float, cy: float, bw: float, bh: float,
             theta: float) -> List[Tuple[float, float]]:
    c, s = np.cos(theta), np.sin(theta)
    pts = []
    for dx, dy in ((-bw / 2, -bh / 2), (bw / 2, -bh / 2),
                   (bw / 2, bh / 2), (-bw / 2, bh / 2)):
        pts.append((cx + dx * c - dy * s, cy + dx * s + dy * c))
    return pts


def make_detection_image(rng: np.random.Generator, w: int, h: int,
                         max_objects: int = 8
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic scene. Returns (uint8 HWC image, labels (n,5) of
    [cls, cx, cy, bw, bh] normalized — the YOLO label-file convention,
    yolov3/utils/datasets.py:316-322)."""
    from PIL import Image, ImageDraw

    base = rng.integers(40, 200, 3)
    img = Image.fromarray(_background(rng, h, w, base))
    draw = ImageDraw.Draw(img)

    # unlabeled distractors: thin lines + tiny specks (below minimum
    # object size; must not be detected)
    for _ in range(rng.integers(2, 7)):
        x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
        x1, y1 = x0 + rng.uniform(-120, 120), y0 + rng.uniform(-120, 120)
        draw.line([x0, y0, x1, y1],
                  fill=tuple(int(v) for v in rng.integers(0, 255, 3)),
                  width=int(rng.integers(1, 3)))
    for _ in range(rng.integers(0, 6)):
        x, y = rng.uniform(0, w - 5), rng.uniform(0, h - 5)
        r = rng.uniform(1, 3)
        draw.ellipse([x, y, x + r, y + r],
                     fill=tuple(int(v) for v in rng.integers(0, 255, 3)))

    labels = []
    for _ in range(rng.integers(1, max_objects + 1)):
        cls = int(rng.integers(0, len(DET_CLASS_NAMES)))
        scale = float(rng.uniform(0.05, 0.30))
        if cls == 0:  # victim: warm-tone ellipse, mild aspect ratio
            bw = scale * min(w, h)
            bh = bw * float(rng.uniform(0.6, 1.7))
            cx = float(rng.uniform(bw / 2, w - bw / 2))
            cy = float(rng.uniform(bh / 2, h - bh / 2))
            color = (int(rng.integers(170, 255)),
                     int(rng.integers(90, 190)),
                     int(rng.integers(40, 140)))
            draw.ellipse([cx - bw / 2, cy - bh / 2,
                          cx + bw / 2, cy + bh / 2], fill=color,
                         outline=(0, 0, 0))
            x0, y0 = cx - bw / 2, cy - bh / 2
            x1, y1 = cx + bw / 2, cy + bh / 2
        else:  # vehicle: rotated saturated box; bbox is the hull extent
            side = scale * min(w, h)
            bw_o, bh_o = side * float(rng.uniform(1.3, 2.4)), side
            theta = float(rng.uniform(0, np.pi))
            # conservative hull radius; shrink the box if the placement
            # band would go negative on narrow images
            m = (bw_o + bh_o) / 2
            lim = 0.45 * min(w, h)
            if m > lim:
                k = lim / m
                bw_o, bh_o, m = bw_o * k, bh_o * k, lim
            cx = float(rng.uniform(m, w - m))
            cy = float(rng.uniform(m, h - m))
            hue = rng.permutation([int(rng.integers(170, 255)),
                                   int(rng.integers(0, 90)),
                                   int(rng.integers(0, 90))])
            pts = _rot_box(cx, cy, bw_o, bh_o, theta)
            draw.polygon(pts, fill=tuple(int(v) for v in hue),
                         outline=(255, 255, 255))
            xs, ys = zip(*pts)
            x0, y0, x1, y1 = min(xs), min(ys), max(xs), max(ys)
        x0, y0 = max(0.0, x0), max(0.0, y0)
        x1, y1 = min(float(w), x1), min(float(h), y1)
        labels.append([cls, (x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                       (x1 - x0) / w, (y1 - y0) / h])
    return np.asarray(img), np.asarray(labels, np.float32)


def generate_detection_dataset(root, n_train: int = 800, n_val: int = 100,
                               seed: int = 0,
                               sizes: Sequence[Tuple[int, int]] = DET_SIZES,
                               jpeg_quality: int = 90) -> Tuple[str, str]:
    """Write a darknet-layout detection dataset under `root`:

        root/data/synth.data      classes/train/valid/names (.data keys,
                                  yolov3/utils/parse_config.py:55-71)
        root/data/synth.yaml      the same set as a v5 data yaml
        root/data/{train,valid}.txt   absolute image paths
        root/data/images/{train,val}/NNNNNN.jpg
        root/data/labels/{train,val}/NNNNNN.txt   YOLO cls cx cy w h rows
                                  (/images/->/labels/ convention,
                                  yolov5/utils/datasets.py:356-360)

    Returns (path to .data, path to .yaml).
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    root = Path(root)
    data_dir = root / "data"
    lists = {}
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = data_dir / "images" / split
        lab_dir = data_dir / "labels" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        lab_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for i in range(n):
            w, h = sizes[int(rng.integers(0, len(sizes)))]
            img, labels = make_detection_image(rng, w, h)
            p = img_dir / f"{i:06d}.jpg"
            Image.fromarray(img).save(p, quality=jpeg_quality)
            with open(lab_dir / f"{i:06d}.txt", "w") as f:
                for row in labels:
                    f.write(f"{int(row[0])} " +
                            " ".join(f"{v:.6f}" for v in row[1:]) + "\n")
            paths.append(str(p.resolve()))
        lists[split] = paths
    with open(data_dir / "train.txt", "w") as f:
        f.write("\n".join(lists["train"]) + "\n")
    with open(data_dir / "valid.txt", "w") as f:
        f.write("\n".join(lists["val"]) + "\n")
    with open(data_dir / "synth.names", "w") as f:
        f.write("\n".join(DET_CLASS_NAMES) + "\n")
    data_path = data_dir / "synth.data"
    with open(data_path, "w") as f:
        f.write(f"classes={len(DET_CLASS_NAMES)}\n"
                f"train=data/train.txt\nvalid=data/valid.txt\n"
                f"names=data/synth.names\n")
    yaml_path = data_dir / "synth.yaml"
    with open(yaml_path, "w") as f:
        f.write(f"train: data/train.txt\nval: data/valid.txt\n"
                f"nc: {len(DET_CLASS_NAMES)}\n"
                f"names: {list(DET_CLASS_NAMES)}\n")
    return str(data_path), str(yaml_path)


# ---------------------------------------------------------------- cls --


def _cls_collapsed(rng, draw, w, h):
    for _ in range(rng.integers(25, 60)):  # angular gray/brown rubble
        g = int(rng.integers(60, 180))
        tint = rng.integers(-25, 25, 3)
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        s = rng.uniform(6, 40)
        pts = _rot_box(cx, cy, s * rng.uniform(0.5, 2.0), s,
                       rng.uniform(0, np.pi))
        draw.polygon(pts, fill=tuple(
            int(np.clip(g + t, 0, 255)) for t in tint))


def _cls_fire(rng, draw, w, h):
    for _ in range(rng.integers(8, 20)):  # layered warm blobs on dark
        cx, cy = rng.uniform(0, w), rng.uniform(h * 0.3, h)
        r = rng.uniform(8, 50)
        for k, (rr, col) in enumerate((
                (r, (int(rng.integers(150, 230)), int(rng.integers(0, 60)),
                     0)),
                (r * 0.6, (255, int(rng.integers(90, 170)), 0)),
                (r * 0.3, (255, int(rng.integers(190, 255)),
                           int(rng.integers(0, 120)))))):
            draw.ellipse([cx - rr, cy - rr * 1.4, cx + rr, cy + rr],
                         fill=col)


def _cls_flood(rng, draw, w, h):
    y = 0.0
    while y < h:  # horizontal wave bands of water tones
        band = rng.uniform(4, 14)
        col = (int(rng.integers(10, 70)), int(rng.integers(60, 140)),
               int(rng.integers(120, 210)))
        amp, phase = rng.uniform(1, 5), rng.uniform(0, 2 * np.pi)
        pts = [(x, y + amp * np.sin(x / 18.0 + phase))
               for x in range(0, w + 1, 8)]
        pts += [(w, y + band + 20), (0, y + band + 20)]
        draw.polygon(pts, fill=col)
        y += band


def _cls_normal(rng, draw, w, h):
    for _ in range(rng.integers(10, 30)):  # green field patches
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        s = rng.uniform(10, 60)
        col = (int(rng.integers(20, 90)), int(rng.integers(110, 200)),
               int(rng.integers(20, 90)))
        draw.ellipse([cx - s, cy - s * 0.7, cx + s, cy + s * 0.7], fill=col)


def _cls_traffic(rng, draw, w, h):
    road_y = rng.uniform(0.25, 0.6) * h  # gray road + dashes + cars
    road_h = rng.uniform(0.25, 0.4) * h
    g = int(rng.integers(70, 110))
    draw.rectangle([0, road_y, w, road_y + road_h], fill=(g, g, g))
    for x in range(0, w, 24):
        draw.rectangle([x, road_y + road_h / 2 - 2, x + 12,
                        road_y + road_h / 2 + 2], fill=(230, 230, 210))
    for _ in range(rng.integers(2, 6)):
        cx = rng.uniform(10, w - 10)
        cy = road_y + rng.uniform(0.15, 0.85) * road_h
        cw, ch = rng.uniform(14, 30), rng.uniform(8, 14)
        col = tuple(int(v) for v in rng.integers(0, 255, 3))
        th = rng.uniform(-0.3, 0.3)
        draw.polygon(_rot_box(cx, cy, cw, ch, th), fill=col)


_CLS_PAINTERS = (_cls_collapsed, _cls_fire, _cls_flood, _cls_normal,
                 _cls_traffic)
_CLS_BASES = ((120, 115, 110), (25, 12, 8), (20, 40, 90), (60, 130, 60),
              (50, 55, 50))


def make_classification_image(rng: np.random.Generator, label: int,
                              w: int, h: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    img = Image.fromarray(_background(rng, h, w, _CLS_BASES[label], var=25))
    _CLS_PAINTERS[label](rng, ImageDraw.Draw(img), w, h)
    arr = np.asarray(img).astype(np.float32)
    arr += rng.normal(0, 5.0, arr.shape).astype(np.float32)
    return np.clip(arr, 0, 255).astype(np.uint8)


def generate_classification_dataset(root, n_train_per_class: int = 160,
                                    n_val_per_class: int = 25,
                                    n_test_per_class: int = 25,
                                    seed: int = 0,
                                    jpeg_quality: int = 90) -> str:
    """Write an AIDER-layout classification dataset under `root`:
    class-named image dirs + {train,val,test}.csv of (relative_path,label)
    rows — exactly what AiderDataset consumes (data/aider.py). Native
    sizes vary around 1.5-2x the 140px model input so the eval
    resize+center-crop path is exercised. Returns `root` as root_dir."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root = Path(root)
    rows = {"train": [], "val": [], "test": []}
    counts = (("train", n_train_per_class), ("val", n_val_per_class),
              ("test", n_test_per_class))
    for label, name in enumerate(AIDER_CLASS_NAMES):
        (root / name).mkdir(parents=True, exist_ok=True)
        idx = 0
        for split, n in counts:
            for _ in range(n):
                w = int(rng.integers(200, 340))
                h = int(rng.integers(200, 340))
                img = make_classification_image(rng, label, w, h)
                rel = f"{name}/{name}_{idx:04d}.jpg"
                Image.fromarray(img).save(root / rel, quality=jpeg_quality)
                rows[split].append(f"{rel},{label}")
                idx += 1
    for split in rows:
        order = rng.permutation(len(rows[split]))
        with open(root / f"synth_{split}.csv", "w") as f:
            f.write("\n".join(rows[split][i] for i in order) + "\n")
    return str(root)
