#!/usr/bin/env python3
"""Host cost of the ACFF wrapper and of a small-batch engine call, on one
NVIDIA GPU, for one checkout of the port.

Run from the root of a checkout, on a machine with an H100:

    python3 scripts/acff_host_cost.py [--root CHECKOUT]

At batch 1, 8 and 32, for the four ACFF blocks of Squeeze_ErNET in bf16:
the host time to enqueue one ``acff_infer`` call (the mean of 200 calls
back to back, the device not waited for) beside the call's device time
(a CUDA-graph replay, ``chip_smoke.graph_ms``); then the host-clock
latency of the Squeeze_ErNET bf16 engine, median and p90 of 200 calls
after 20 warm-up calls. ``--root`` names the checkout whose
``rtdm_tpu_torch`` is measured (default: this one), so that two commits
can be measured in turns in one call on one card. Prints one line per
measurement, then one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
SHAPES = [(16, 64, 69), (64, 96, 33), (96, 128, 15), (128, 256, 6)]
BATCHES = (1, 8, 32)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wrapper_cost(ops, graph_ms, rng, b):
    """(host ms, device ms) of one acff_infer call at each shape."""
    rows = []
    for c, o, h in SHAPES:
        host = [rng.standard_normal((b, h, h, c), dtype=np.float32),
                rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
                rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
                rng.normal(size=o), rng.uniform(0.5, 1.5, o),
                rng.normal(size=o)]
        a = [torch.from_numpy(v.astype(np.float32)).cuda() for v in host]
        a[0] = a[0].bfloat16()
        # a checkout from before the packed B operand takes seven arguments
        if hasattr(ops, "pack_fuse_operand"):
            a.append(ops.pack_fuse_operand(a[3]))
        for _ in range(5):
            ops.acff_infer(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            ops.acff_infer(*a)
        host_ms = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        rows.append((c, o, h, host_ms, graph_ms(lambda: ops.acff_infer(*a),
                                                20)))
    return rows


def engine_latency(root, b):
    """(median, p90) host-clock ms of one Squeeze_ErNET bf16 engine call."""
    from rtdm_tpu_torch.export.engine import Engine
    loaded = Engine.load(str(root / "artifacts" / "engines" /
                             "squeeze-ernet_bf16"))
    eng = Engine(dataclasses.replace(loaded.spec, batch_size=b),
                 loaded.variables)
    x = np.random.default_rng(0).integers(0, 256, (b, 140, 140, 3),
                                          dtype=np.uint8)
    for _ in range(20):
        eng(x)
    torch.cuda.synchronize()
    samples = []
    for _ in range(200):
        t0 = time.perf_counter()
        eng(x)              # ends in a device-to-host copy: synchronised
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    return samples[100], samples[180]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="checkout whose rtdm_tpu_torch is measured")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    smoke = load_chip_smoke()
    sys.path.insert(0, str(root))
    from rtdm_tpu_torch.ops import acff as ops
    if Path(ops.__file__).resolve().parents[2] != root:
        raise SystemExit(f"rtdm_tpu_torch was not imported from {root}")
    card = smoke.card_line()
    rng = np.random.default_rng(0)
    result = {"root": root.name, "card": card, "wrapper": {}, "engine": {}}
    for b in BATCHES:
        rows = wrapper_cost(ops, smoke.graph_ms, rng, b)
        for c, o, h, host_ms, dev_ms in rows:
            print(f"{root.name} batch {b} acff {h}^2 {c}->{o}: host enqueue "
                  f"{host_ms:.4f} ms, device {dev_ms:.4f} ms [{card}]",
                  flush=True)
        host_sum = sum(r[3] for r in rows)
        dev_sum = sum(r[4] for r in rows)
        med, p90 = engine_latency(root, b)
        print(f"{root.name} batch {b}: four ACFF calls host {host_sum:.4f} "
              f"ms, device {dev_sum:.4f} ms; engine median {med:.4f} ms, "
              f"p90 {p90:.4f} ms (n=200, host clock) [{card}]", flush=True)
        result["wrapper"][b] = {"host_ms": host_sum, "device_ms": dev_sum}
        result["engine"][b] = {"median_ms": med, "p90_ms": p90}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
