"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up (imports and CUDA, the ACFF library,
the engine, the frames, the warm-up of the cell's own shapes) is timed as
``setup_s``; then the traffic mix drives the system for ``--seconds``;
then, with the program's state freed, the plain reference computes every
pool frame once and the cell's check compares every answer of the window
with it. With ``--trace 0`` the result carries the cell's end-to-end
metrics; with ``--trace 1`` the window runs under ``torch.profiler`` and
the result carries its per-layer metrics, ``busy_s``, ``window_s`` and a
``breakdown``. Exits non-zero, printing no result, without enough CUDA
devices, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "rtdm_tpu")


def cache_environment(root: str) -> None:
    """Every compile cache at a fixed directory inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")
    os.environ["USE_FLAX"] = "0"


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT):
    """``benchmark/<kind>/<name>.py`` of the checkout at ``root`` as a
    module (names may hold dots)."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve_cell(root: str, workload: str):
    """(BENCHMARK.json, the cell, its configuration, its traffic mix)."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root, config_entry["file"])
    traffic = load_json(root, "benchmark", "traffic",
                        cell["traffic"] + ".json")
    return bench, cell, config, traffic


def metrics_of(bench: Dict, cell: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  .intersection(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_up(config: Dict, traffic: Dict, seed: int, device: str,
           phases: Dict[str, float], root: str = ROOT, batch: int = 0,
           pool_batches: int = 0, patch=None):
    """The system under test, built and warmed up on the cell's own shapes,
    its pool of frames for ``seed`` and the frames the loop hands it
    (``loops.feed``): (system, pool, ring). What set-up made lives to the
    end, so the collector is told not to walk it."""
    import torch
    from benchmark import frames, loops
    system = load_module("systems", config["system"], root).System(
        config, root, device, phases, batch=batch)
    if patch is not None:
        patch(system)
    t = time.perf_counter()
    pool = frames.make_pool(
        root, seed, (pool_batches or int(traffic["pool_batches"]))
        * system.batch, system.size, system.fit)
    ring = ring_of(pool, system.batch, traffic, device)
    phases["frames_s"] = time.perf_counter() - t
    t = time.perf_counter()
    system.warmup(ring)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    phases["warmup_s"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()
    return system, pool, ring


def ring_of(pool, batch: int, traffic: Dict, device: str):
    """``pool`` as the traffic mix hands it over (``loops.feed``)."""
    from benchmark import loops
    return loops.feed(pool, batch, traffic.get("host_memory", "pageable"),
                      device.startswith("cuda"))


def window(system, ring, traffic: Dict, seconds: float):
    """The traffic mix driving ``system`` over ``ring`` for ``seconds``."""
    from benchmark import loops
    return loops.closed_loop(system, ring, seconds, int(traffic["depth"]))


def judge(check_mod, ref_mod, ref_state, answers, pool, device,
          attempted: int) -> Dict[str, float]:
    """The cell's check of ``answers`` (the system's ``answers(win)``)
    against the plain reference over the whole pool; of the ``attempted``
    frames, those with no answer are ``missing``."""
    reference = ref_mod.forward(ref_state, pool, device)
    return check_mod.compare(*answers, reference,
                             missing=attempted - len(answers[0]))


def main(argv=None, *, device: Optional[str] = None,
         overrides: Optional[Dict] = None, root: str = ROOT) -> int:
    """``device`` and ``overrides`` are for the CPU tests only: they run a
    cell on the CPU (``device="cpu"``) at a smaller ``batch`` and
    ``pool_batches``, with ``patch(system)`` breaking the timed path."""
    args = parse_args(argv)
    overrides = overrides or {}
    cache_environment(root)
    bench, cell, config, traffic = resolve_cell(root, args.workload)
    phases: Dict[str, float] = {}
    t = time.perf_counter()
    import torch
    from benchmark import trace
    if device is None:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if seen < int(cell["chips"]):
            print(f"benchmark: the cell needs {cell['chips']} CUDA "
                  f"device(s); torch sees {seen}", file=sys.stderr)
            return 2
        device = "cuda"
        torch.zeros(1, device=device)
    on_card = device.startswith("cuda")
    phases["imports_cuda_s"] = time.perf_counter() - t

    system, pool, ring = set_up(
        config, traffic, args.seed, device, phases, root,
        batch=int(overrides.get("batch", 0)),
        pool_batches=int(overrides.get("pool_batches", 0)),
        patch=overrides.get("patch"))
    setup_s = time.perf_counter() - _T0

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
    with prof if prof is not None else contextlib.nullcontext():
        win = window(system, ring, traffic, args.seconds)
        if on_card:
            torch.cuda.synchronize()
    summary = None
    if prof is not None:
        events = trace.from_profiler(prof)
        summary = trace.summarize(events)
        print(trace.describe(events, summary), file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    answers = system.answers(win)
    del system, ring
    win.answers = []
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref_mod = load_module("reference", config["reference"], root)
    t = time.perf_counter()
    ref_state = ref_mod.load(config, root, device)
    numbers = judge(load_module("checks", config["check"], root), ref_mod,
                    ref_state, answers, pool, device, win.attempted)
    reference_s = time.perf_counter() - t
    limits = config["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)

    ctx = SimpleNamespace(
        cell=cell, config=config, traffic=traffic, win=win, summary=summary,
        setup_s=setup_s, flops_per_frame=ref_mod.flops_per_frame(config, ref_state),
        ref_state=ref_state, ref_mod=ref_mod)
    metrics = {}
    for m in metrics_of(bench, cell, bool(args.trace)):
        value = load_module("metrics", m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    limit_w = power_limit() if on_card else None
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(memory_peak),
        "power_limit": limit_w,
    }
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(numbers["missing"]), "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_device_ops(),
                               "idle_gaps": summary.top_idle_gaps()}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}

    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("setup phases: " + ", ".join(
        f"{k}={v:.4f}" for k, v in phases.items())
        + f", setup_s={setup_s:.4f}, reference_s={reference_s:.4f}",
        file=sys.stderr)
    print(f"device: {limit_w}; flops a frame {ctx.flops_per_frame}",
          file=sys.stderr)
    for k in limits:
        print(f"check {k}: {numbers[k]!r} (limit {limits[k]!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
