#!/usr/bin/env python3
"""Host cost of the ACFF wrapper, of the registered op and of a
small-batch engine call, on one NVIDIA GPU, for one checkout of the port.

Run from the root of a checkout, on a machine with an H100:

    python3 scripts/acff_host_cost.py [--root CHECKOUT]

At batch 1, 8, 32 and 256, for the four ACFF blocks of Squeeze_ErNET in
bf16, the host time to enqueue one call (the mean of 200 calls back to
back, the device not waited for) of each layer the engines' blocks go
through, beside the call's device time (a CUDA-graph replay,
``chip_smoke.graph_ms``):

- ``wrapper``: ``acff_infer`` with the block's ``FuseOperands``;
- ``route``: the op's CUDA route called as a function
  (``_acff_infer_cuda``: the wrapper's work and the route's own);
- ``op``: the op ``rtdm::acff_infer`` (the route and the dispatcher);
- ``block``: an ``ACFF`` module's inference forward (the op, or in a
  checkout without it the wrapper, and the forward's own work).

So op - route is the dispatcher's share, route - wrapper the route's own
Python work, block - op the forward's. ``route`` and ``op`` are absent
where the checkout has no op. Then the host-clock latency of the
Squeeze_ErNET bf16 engine, median and p90 of 200 calls after 20 warm-up
calls. ``--root`` names the checkout whose ``rtdm_tpu_torch`` is
measured (default: this one), so that commits can be measured in turns
in one call on one card (one process each: a process registers one
op). Prints one line per measurement, then one JSON object.
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
BATCHES = (1, 8, 32, 256)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ms(fn, calls=200):
    """Mean host ms to enqueue one ``fn`` call, the device not waited
    for."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


LAYERS = ("wrapper", "route", "op", "block")


def layer_cost(ops, graph_ms, rng, b):
    """[(C, O, H, device ms, {layer: host ms})] of one call at each
    shape."""
    from rtdm_tpu_torch.models.acff import ACFF
    rows = []
    for c, o, h in SHAPES:
        host = [rng.standard_normal((b, h, h, c), dtype=np.float32),
                rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
                rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
                rng.normal(size=o), rng.uniform(0.5, 1.5, o),
                rng.normal(size=o)]
        a = [torch.from_numpy(v.astype(np.float32)).cuda() for v in host]
        a[0] = a[0].bfloat16()
        fuse = ops.FuseOperands(a[3], torch.bfloat16)
        calls = {"wrapper": lambda: ops.acff_infer(*a, fuse)}
        if hasattr(ops, "acff_infer_op"):
            shaped = fuse.for_shape(h, h)
            # a checkout whose op took the operands' keys beside them
            extra = list(shaped) if isinstance(shaped, tuple) else [shaped]
            calls["route"] = lambda: ops._acff_infer_cuda(*a[:7], *extra,
                                                          None)
            calls["op"] = lambda: ops.acff_infer_op(*a[:7], *extra, None)
        torch.manual_seed(0)
        block = ACFF(c, o).to("cuda", torch.bfloat16).eval()
        calls["block"] = lambda: block(a[0])
        with torch.no_grad():
            rows.append((c, o, h, graph_ms(calls["wrapper"], 20),
                         {k: host_ms(f) for k, f in calls.items()}))
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
    result = {"root": root.name, "card": card, "host_ms": {}, "engine": {}}
    for b in BATCHES:
        rows = layer_cost(ops, smoke.graph_ms, rng, b)
        for c, o, h, dev_ms, host in rows:
            print(f"{root.name} batch {b} acff {h}^2 {c}->{o}: host enqueue "
                  + ", ".join(f"{k} {v:.4f}" for k, v in host.items())
                  + f" ms; device {dev_ms:.4f} ms [{card}]", flush=True)
        sums = {k: sum(r[4][k] for r in rows) for k in LAYERS
                if k in rows[0][4]}
        sums["device"] = sum(r[3] for r in rows)
        med, p90 = engine_latency(root, b)
        print(f"{root.name} batch {b}: four ACFF blocks, host "
              + ", ".join(f"{k} {v:.4f}" for k, v in sums.items())
              + f" ms; engine median {med:.4f} ms, p90 {p90:.4f} ms (n=200, "
              f"host clock) [{card}]", flush=True)
        result["host_ms"][b] = sums
        result["engine"][b] = {"median_ms": med, "p90_ms": p90}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
