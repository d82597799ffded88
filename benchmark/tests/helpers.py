"""Running a cell of the benchmark on the CPU at a small size."""

import json

from benchmark import run


def run_cell(capsys, workload, *, seed=11, seconds=1.0, trace=0, root=None,
             **overrides):
    """``run.main`` on the CPU; returns (exit code, the result line)."""
    kw = {"root": root} if root else {}
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  overrides=overrides, **kw)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)

