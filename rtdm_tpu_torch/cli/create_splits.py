"""Stratified dataset split generator.

Counterpart of ``rtdm_tpu/cli/create_splits.py`` (the reference's
dataloaders/create_splits.py:8-176): 70/20/10 splits of a labels CSV
(path,label), stratified by class, from seed 42, written as
``<prefix>_{train,val,test}.csv``; ``--plot`` adds the class-distribution
bar chart (matplotlib, imported only then).

Run: python -m rtdm_tpu_torch.cli.create_splits --labels aider_labels.csv \
         --output-dir splits/
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

import numpy as np


def stratified_split(rows, ratios=(0.7, 0.2, 0.1), seed=42):
    by_class = defaultdict(list)
    for path, label in rows:
        by_class[int(label)].append((path, int(label)))
    rng = np.random.default_rng(seed)
    splits = [[], [], []]
    for label in sorted(by_class):
        items = by_class[label]
        order = rng.permutation(len(items))
        n = len(items)
        n_train = int(round(n * ratios[0]))
        n_val = int(round(n * ratios[1]))
        for j, k in enumerate(order):
            if j < n_train:
                splits[0].append(items[k])
            elif j < n_train + n_val:
                splits[1].append(items[k])
            else:
                splits[2].append(items[k])
    for s in splits:
        rng.shuffle(s)
    return splits


def main(argv=None):
    p = argparse.ArgumentParser(description="Stratified 70/20/10 splits")
    p.add_argument("--labels", required=True, help="labels csv (path,label)")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--prefix", default="aider")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--ratios", nargs=3, type=float, default=[0.7, 0.2, 0.1])
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)

    with open(args.labels, newline="") as f:
        rows = [(r[0], int(r[1])) for r in csv.reader(f) if len(r) >= 2]
    splits = stratified_split(rows, tuple(args.ratios), args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    names = ["train", "val", "test"]
    for name, data in zip(names, splits):
        path = os.path.join(args.output_dir, f"{args.prefix}_{name}.csv")
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows(data)
        counts = np.bincount([lbl for _, lbl in data])
        print(f"{name}: {len(data)} rows, class counts {counts.tolist()}")
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        width = 0.25
        nclasses = max(lbl for _, lbl in rows) + 1
        for i, (name, data) in enumerate(zip(names, splits)):
            counts = np.bincount([lbl for _, lbl in data],
                                 minlength=nclasses)
            ax.bar(np.arange(nclasses) + i * width, counts, width,
                   label=name)
        ax.legend()
        ax.set_xlabel("class")
        out = os.path.join(args.output_dir, "class_distribution.png")
        fig.savefig(out, dpi=110, bbox_inches="tight")
        print(f"plot: {out}")
    return splits


if __name__ == "__main__":
    main()
