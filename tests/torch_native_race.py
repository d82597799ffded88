"""Reproduce the JAX package's native-IO build race, and its repair in
the port's tests.

The JAX package builds ``native/librtdm_io.so`` at its first use with
``make clean all`` and no lock across processes
(``rtdm_tpu/data/native_io.py``). Processes that reach that first use
together, as ``pytest -n`` workers do, can delete the library another is
loading; the loser marks its one try done and decodes with PIL for the
rest of its life. The port builds into ``build/native/`` through a
temporary file and ``os.replace``.

Run on a COPY of a checkout (the script deletes the copy's
``native/librtdm_io.so`` and ``build/`` before each trial):

    git archive $(git write-tree) | tar -x -C COPY
    python3 -m tests.torch_native_race --root COPY [--procs 6]
        [--trials 8] [--load-both]

Each trial starts ``--procs`` processes that call both packages'
``available()`` at one instant; with ``--load-both`` each then calls
``tests/torch_native_lock.py::load_both`` (a lock shared by the
processes, JAX's ``_tried`` reset for each try). Prints one JSON line per
process, then one summary line per trial, then a JSON total.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def child(root: Path, start: float, lock_dir: str) -> None:
    sys.path.insert(0, str(root))
    from rtdm_tpu.data import native_io as jax_io
    from rtdm_tpu_torch.data import native_io as port_io
    while time.time() < start:
        time.sleep(0.001)
    rec = {"jax": jax_io.available(), "port": port_io.available()}
    if lock_dir:
        from tests.torch_native_lock import load_both
        try:
            load_both(Path(lock_dir))
        except AssertionError as e:
            rec["load_both_error"] = str(e)
        rec["jax_after_load_both"] = jax_io.available()
    print(json.dumps(rec), flush=True)


def trial(root: Path, procs: int, lock_dir: str) -> list:
    (root / "native" / "librtdm_io.so").unlink(missing_ok=True)
    shutil.rmtree(root / "build", ignore_errors=True)
    start = time.time() + 4.0           # every process imported by then
    runs = [subprocess.Popen(
        [sys.executable, __file__, "--child", "--root", str(root),
         "--start", repr(start), "--lock-dir", lock_dir],
        stdout=subprocess.PIPE, text=True) for _ in range(procs)]
    out = []
    for p in runs:
        stdout, _ = p.communicate(timeout=600)
        if p.returncode:
            raise SystemExit(f"a process failed with {p.returncode}")
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", type=Path, required=True,
                   help="a copy of a checkout (its native/ is rebuilt)")
    p.add_argument("--procs", type=int, default=6)
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--load-both", action="store_true")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--start", type=float, help=argparse.SUPPRESS)
    p.add_argument("--lock-dir", default="", help=argparse.SUPPRESS)
    args = p.parse_args()
    root = args.root.resolve()
    if args.child:
        child(root, args.start, args.lock_dir)
        return 0
    if root == HERE:
        raise SystemExit("--root must be a copy: the script deletes its "
                         "native/librtdm_io.so")
    total = {"procs": 0, "jax_failed": 0, "port_failed": 0,
             "jax_failed_after_load_both": 0}
    with tempfile.TemporaryDirectory() as lock_dir:
        for t in range(args.trials):
            recs = trial(root, args.procs,
                         lock_dir if args.load_both else "")
            for r in recs:
                print(json.dumps(r))
            failed = sum(not r["jax"] for r in recs)
            total["procs"] += len(recs)
            total["jax_failed"] += failed
            total["port_failed"] += sum(not r["port"] for r in recs)
            total["jax_failed_after_load_both"] += sum(
                not r.get("jax_after_load_both", True) for r in recs)
            print(f"trial {t}: JAX's first load failed (PIL for the "
                  f"process's life) in {failed} of {len(recs)} processes")
    print(json.dumps(total))
    return 0


if __name__ == "__main__":
    sys.exit(main())
