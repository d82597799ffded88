"""Training and detection plots.

Counterpart of ``rtdm_tpu/utils/plots.py``: the classifier's training
curves (``plot_training_curves``: loss, accuracy, F1 and lr PNGs after
training, matplotlib), the annotated batch mosaics of ``yolo_test
--plot-dir`` (``plot_detection_batch``, PIL only; plot_images,
yolov5/utils/plots.py:128) and the label-statistics panel
(``plot_label_distribution``, matplotlib; plot_labels :285); matplotlib is
imported where a panel is drawn. The evolution panels come with YOLO
training.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence


def plot_training_curves(history: Dict[str, Sequence[float]],
                         out_dir: str, prefix: str = "training") -> list:
    """history keys like train_loss/val_loss/train_acc/val_acc/val_f1/lr."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    panels = [
        ("loss", ["train_loss", "val_loss"]),
        ("accuracy", ["train_acc", "val_acc"]),
        ("f1", ["val_f1"]),
        ("lr", ["lr"]),
    ]
    for name, keys in panels:
        keys = [k for k in keys if k in history and len(history[k])]
        if not keys:
            continue
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for k in keys:
            ax.plot(history[k], label=k)
        ax.set_xlabel("epoch")
        ax.set_title(name)
        ax.legend()
        ax.grid(alpha=0.3)
        path = os.path.join(out_dir, f"{prefix}_{name}.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


_BOX_COLORS = [(255, 56, 56), (72, 249, 10), (61, 219, 255), (255, 178, 29),
               (207, 210, 49), (26, 147, 52), (132, 56, 255), (10, 31, 255)]


def plot_detection_batch(images, labels, num_labels, path,
                         names: Sequence[str] = (),
                         max_subplots: int = 16, tile: int = 256,
                         scores=None) -> str:
    """Annotated mosaic of one batch (train_batch*.jpg /
    test_batch*_{labels,pred}.jpg in the reference, plot_images
    yolov5/utils/plots.py:128, consumed by train.py:299 and test.py:215).

    images: (B,H,W,3) uint8 NHWC; labels: (B,M,5) rows [cls,cx,cy,w,h] in
    PIXELS at the batch resolution (the loader's fixed-shape convention);
    num_labels: (B,) valid row counts; scores: optional (B,M) confidences
    appended to each box tag (the prediction-panel variant).
    """
    import math

    import numpy as np
    from PIL import Image, ImageDraw

    n = min(len(images), max_subplots)
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    h, w = images.shape[1:3]
    scale = tile / max(h, w)
    tw, th = int(round(w * scale)), int(round(h * scale))
    grid = Image.new("RGB", (cols * tw, rows * th), (114, 114, 114))
    for i in range(n):
        im = Image.fromarray(np.asarray(images[i], np.uint8)).resize(
            (tw, th), Image.BILINEAR)
        d = ImageDraw.Draw(im)
        for j, (cls, cx, cy, bw, bh) in enumerate(np.asarray(
                labels[i][:int(num_labels[i])], np.float32)):
            x1, y1 = (cx - bw / 2) * scale, (cy - bh / 2) * scale
            x2, y2 = (cx + bw / 2) * scale, (cy + bh / 2) * scale
            color = _BOX_COLORS[int(cls) % len(_BOX_COLORS)]
            d.rectangle([x1, y1, x2, y2], outline=color, width=2)
            tag = (names[int(cls)] if int(cls) < len(names) else str(int(cls)))
            if scores is not None:
                tag += f" {float(scores[i][j]):.2f}"
            d.text((x1 + 2, max(y1 - 11, 0)), tag, fill=color)
        grid.paste(im, ((i % cols) * tw, (i // cols) * th))
    grid.save(path, quality=90)
    return path


def plot_label_distribution(label_rows, path,
                            names: Sequence[str] = ()) -> str:
    """Label-statistics panel at train start (plot_labels,
    yolov5/utils/plots.py:285): class histogram + normalized xy and wh
    2-D histograms. label_rows: (N,5) [cls, cx, cy, w, h], coords in
    [0,1] (the on-disk darknet label convention)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    rows = np.asarray(label_rows, np.float32).reshape(-1, 5)
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    nc = int(rows[:, 0].max()) + 1 if len(rows) else 1
    counts = np.bincount(rows[:, 0].astype(int), minlength=nc) \
        if len(rows) else np.zeros(1)
    axes[0].bar(range(len(counts)), counts, color="#4c72b0")
    axes[0].set_xticks(range(len(counts)))
    if names:
        axes[0].set_xticklabels(
            [names[c] if c < len(names) else str(c)
             for c in range(len(counts))], rotation=30, ha="right")
    axes[0].set_title(f"instances per class (n={len(rows)})")
    for ax, (i, j), title in ((axes[1], (1, 2), "box centers (x, y)"),
                              (axes[2], (3, 4), "box sizes (w, h)")):
        if len(rows):
            ax.hist2d(rows[:, i], rows[:, j], bins=40, cmap="Blues")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
