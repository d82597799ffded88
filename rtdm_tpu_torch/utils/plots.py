"""Training and detection plots.

Counterpart of ``rtdm_tpu/utils/plots.py``: the classifier's training
curves (``plot_training_curves``: loss, accuracy, F1 and lr PNGs after
training, matplotlib), the annotated batch mosaics of ``yolo_test
--plot-dir`` (``plot_detection_batch``, PIL only; plot_images,
yolov5/utils/plots.py:128) and the label-statistics panel
(``plot_label_distribution``, matplotlib; plot_labels :285), and the
detector trainer's results.txt curves (``plot_detector_results``,
plot_results :413) and hyperparameter-evolution scatter
(``plot_evolution_results``, plot_evolution :334); matplotlib is imported
where a panel is drawn.
"""

from __future__ import annotations

import os
import re
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


_RESULTS_RE = re.compile(
    r"epoch (\d+)/\d+ box ([\d.eE+-]+) obj ([\d.eE+-]+) cls ([\d.eE+-]+)"
    r".*?(?:\| P ([\d.eE+-]+) R ([\d.eE+-]+) mAP@0\.5 ([\d.eE+-]+))?$")


def plot_detector_results(results_txt: str, path: str) -> str:
    """Loss/metric curves from yolo_train's results.txt (plot_results,
    yolov5/utils/plots.py:413 / yolov3's utils.plot_results)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series: Dict[str, list] = {k: [] for k in
                               ("epoch", "box", "obj", "cls", "P", "R",
                                "mAP@0.5")}
    with open(results_txt) as f:
        for line in f:
            m = _RESULTS_RE.match(line.strip())
            if not m:
                continue
            vals = m.groups()
            series["epoch"].append(int(vals[0]))
            for k, v in zip(("box", "obj", "cls", "P", "R", "mAP@0.5"),
                            vals[1:]):
                series[k].append(float(v) if v is not None else None)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for k in ("box", "obj", "cls"):
        axes[0].plot(series["epoch"], series[k], label=k)
    axes[0].set_title("train losses")
    axes[0].set_xlabel("epoch")
    axes[0].legend()
    axes[0].grid(alpha=0.3)
    for k in ("P", "R", "mAP@0.5"):
        pts = [(e, v) for e, v in zip(series["epoch"], series[k])
               if v is not None]
        if pts:
            axes[1].plot(*zip(*pts), marker="o", label=k)
    axes[1].set_title("val metrics")
    axes[1].set_xlabel("epoch")
    axes[1].legend()
    axes[1].grid(alpha=0.3)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_evolution_results(evolve_txt: str, path: str, keys=None,
                           w_fit=(0.0, 0.0, 0.1, 0.9)) -> str:
    """Fitness-vs-gene scatter panels from the numeric evolve.txt
    (plot_evolution, yolov5/utils/plots.py:334: np.loadtxt, fitness from
    the first 4 result columns, one panel per gene). `keys` names the
    gene columns (evolve.txt column 7 onward, the genome order)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from rtdm_tpu_torch.train.evolve import N_RESULT_COLS, fitness

    x = np.loadtxt(evolve_txt, ndmin=2)
    if x.size == 0:
        raise ValueError(f"no evolve rows in {evolve_txt}")
    fits = fitness(x, w_fit)
    ng = x.shape[1] - N_RESULT_COLS
    keys = list(keys) if keys else [f"gene{i}" for i in range(ng)]
    if len(keys) != ng:
        raise ValueError(f"{len(keys)} keys for {ng} gene columns")
    cols = min(ng, 5)
    rows = -(-ng // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 2.8 * rows),
                             squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.scatter(x[:, N_RESULT_COLS + i], fits, c=range(len(x)),
                   cmap="viridis", s=24)
        ax.set_title(k, fontsize=9)
        ax.grid(alpha=0.3)
    for i in range(ng, rows * cols):
        axes[i // cols][i % cols].axis("off")
    fig.suptitle("fitness vs gene (color = file order)", fontsize=10)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
