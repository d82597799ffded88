"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 -m benchmark.control --workload <name> --seeds 1 2 ... \\
        --control-seeds 1 2 3 --seconds 5

In one process (set-up paid once): for each seed, a short window of the
cell's own traffic at its own sizes through the program, and the cell's
check against the plain reference (the lower reading: the largest over
the seeds); then for each control seed, the reference in the precision
below the configuration's (``control_precision``) put in the program's
place over the seed's whole pool, its answers in the rows of a whole
cycle of the window's batches, held to the same check (the upper reading: the smallest
over the seeds). Prints one JSON line a reading. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import frames, loops
from benchmark.run import (ROOT, cache_environment, judge, load_module,
                           resolve_cell, ring_of, set_up, window)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cache_environment(ROOT)
    _, cell, config, traffic = resolve_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = "cuda"
    ref_mod = load_module("reference", config["reference"])
    check_mod = load_module("checks", config["check"])
    ref_state = ref_mod.load(config, ROOT, device)
    system, pool, ring = set_up(config, traffic, args.seeds[0], device, {})
    size, fit, batch = system.size, system.fit, system.batch
    for i, seed in enumerate(args.seeds):
        if i:
            pool = frames.make_pool(ROOT, seed, len(pool), size, fit)
            ring = ring_of(pool, batch, traffic, device)
        t0 = time.perf_counter()
        win = window(system, ring, traffic, args.seconds)
        answers = system.answers(win)
        numbers = judge(check_mod, ref_mod, ref_state, answers, pool, device,
                        win.attempted)
        print(json.dumps({"cell": cell["name"], "side": "program",
                          "seed": seed, "answers": len(answers[1]),
                          "seconds": time.perf_counter() - t0, **numbers}),
              flush=True)
    del system, win, answers, ring
    torch.cuda.empty_cache()
    low = config["control_precision"]
    for seed in args.control_seeds:
        pool = frames.make_pool(ROOT, seed, len(pool), size, fit)
        control = ref_mod.forward(ref_state, pool, device, precision=low)
        ids, slots = loops.cycle(batch, len(pool))
        numbers = judge(check_mod, ref_mod, ref_state,
                        ([control[i] for i in ids], ids, slots), pool,
                        device, len(ids))
        print(json.dumps({"cell": cell["name"], "side": f"control_{low}",
                          "seed": seed, "answers": len(ids), **numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
