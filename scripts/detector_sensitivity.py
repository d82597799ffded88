#!/usr/bin/env python3
"""How far an int8 detector's output moves when its convolutions sum in
another order, against controls that the gates must fail.

Runs the committed int8 detector engines on the 10 golden frames
(``tests/goldens/torch_port/detector_int8.npz``) through the port:

- ``card``: on the card (``--device cuda``, the default);
- ``port``: on the CPU, as it stands;
- ``port_f64_sums``: on the CPU with every conv of the network summed in
  float64 and rounded to fp32 (``conv2d`` of ``models/layers.py`` swapped
  for the measurement), the witness of what summation order alone does;
- ``no_qdq``: on the CPU with the activation QDQ left out (a control);
- ``port_shifted_<s>px``: the CPU run with every box and candidate moved
  right by s pixels, s = 3.5 and one stride, 8 (controls).

It holds every run against the JAX golden, and the sound runs against
each other, with ``rtdm_tpu_torch.eval.detection.compare_detections``
(each run's NMS candidates included) and prints the summaries, each
unmatched detection and whether a run meets the strict gates
(``meets_strict``). The CPU runs alone: ``--device cpu``.

Run from the root of a checkout:
    python3 scripts/detector_sensitivity.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
ENGINES = ("yolov4-tiny-mini_int8", "yolov5s-mini_int8")
SHIFTS = (3.5, 8.0)


@contextlib.contextmanager
def float64_convs():
    """Inside the ``with``, the layers' convs sum in float64 and round the
    result to fp32, then to their usual dtype."""
    import rtdm_tpu_torch.models.layers as layers
    plain = layers.conv2d

    def conv64(x, w, b=None, *args):
        out = plain(x.double(), w.double(),
                    None if b is None else b.double(), *args)
        return out.float().to(x.dtype)
    layers.conv2d = conv64
    try:
        yield
    finally:
        layers.conv2d = plain


def shifted(run, px: float):
    """A run (det, count, candidates) with every box moved right by px."""
    det, count, cand = run
    det = det.copy()
    live = np.arange(det.shape[1]) < count[:, None]
    det[..., [0, 2]] += px * live[..., None]
    move = np.array([px, 0, px, 0, 0, 0])
    return det, count, [c + move for c in cand]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("CUDA is not available: pass --device cpu for the CPU runs "
              "alone", file=sys.stderr)
        return 2
    from rtdm_tpu_torch.eval.detection import (candidates, compare_detections,
                                               meets_strict, per_frame,
                                               summary)
    from rtdm_tpu_torch.export.detector import load_detector
    with np.load(ROOT / "tests/goldens/torch_port/detector_int8.npz") as g:
        golden = dict(g)
    x = golden["frames_416"]
    n = len(x)

    def run(det):
        return (*det(x), candidates(det.predictions(x), det.spec.conf_thres))

    for name in ENGINES:
        directory = str(ROOT / "artifacts" / "engines" / name)
        runs = {"golden": (golden[f"det_{name}"], golden[f"count_{name}"],
                           per_frame(golden[f"cand_{name}"], range(n)))}
        if args.device == "cuda":
            runs["card"] = run(load_detector(directory, batch_size=n))
        cpu = load_detector(directory, device="cpu", batch_size=n)
        runs["port"] = run(cpu)
        with float64_convs():
            runs["port_f64_sums"] = run(cpu)
        sound = list(runs)
        for mod in cpu.net.modules():
            mod._forward_pre_hooks.clear()
        cpu._input_scale = None
        runs["no_qdq"] = run(cpu)
        for px in SHIFTS:
            runs[f"port_shifted_{px}px"] = shifted(runs["port"], px)
        spec = cpu.spec
        pairs = [(a, b) for i, a in enumerate(sound) for b in sound[i + 1:]]
        pairs += [("golden", b) for b in runs if b not in sound]
        for a, b in pairs:
            rep = compare_detections(*runs[a][:2], *runs[b][:2],
                                     spec.conf_thres, spec.iou_thres,
                                     runs[a][2], runs[b][2])
            print(f"{name} {b} vs {a}: {summary(rep)}; strict gates: "
                  f"{'met' if meets_strict(rep) else 'missed'}")
            for row in rep["edge_unmatched"]:
                print(f"  at a decision edge: {row}")
            for row in rep["failures"][:8]:
                print(f"  failure: {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
