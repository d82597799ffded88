#!/usr/bin/env python3
"""Where the bf16 ACFF kernel's time goes, by phase, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100:

    python3 scripts/acff_phase_times.py

``ncu`` is not available everywhere the kernel is measured, so this times
variants of ``rtdm_tpu_torch/csrc/acff.cu`` with one phase removed each,
at the four Squeeze_ErNET ACFF shapes and Squeeze_RedConv's acff1 (C=8)
at batch 256: ``no_dw`` (no depthwise features), ``no_mma`` (no wgmma),
``no_epi`` (no epilogue into the staging tile), ``no_store`` (no output
stores) and ``skeleton`` (all four removed: box loads, barriers and loops
only). A variant computes garbage; only its time means anything, and the
time a phase saves when removed is an upper bound on what it costs in the
whole kernel (the phases overlap across resident blocks). Each variant is
a copy of the source edited by exact text replacement, built with
``kernels.nvcc_command`` (the port's flags) into ``build/phase_variants/``;
a replacement that no longer matches the source stops the script, so an
edit of those lines of the kernel is an edit of ``CUTS`` too. Times are
CUDA-graph replays (``chip_smoke.graph_ms``). Prints one line per shape
and a JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import card_line, graph_ms  # noqa: E402
from rtdm_tpu_torch.ops import acff as ops, kernels  # noqa: E402

OUT = ROOT / "build" / "phase_variants"
SHAPES = [(16, 64, 69), (8, 64, 69), (64, 96, 33), (96, 128, 15),
          (128, 256, 6)]
BATCH = 256
CUTS = {
    "no_dw": [(
        "      if (C >= 48) dw_rows<8>(box, wts, a_s, C, kp8, tid);\n"
        "      else if (C >= 16) dw_rows<4>(box, wts, a_s, C, kp8, tid);\n"
        "      else dw_rows<2>(box, wts, a_s, C, kp8, tid);\n", "")],
    "no_mma": [("for (int s = 0; s < kc / 16; ++s)",
                "for (int s = 0; s < 0; ++s)")],
    "no_epi": [(
        "        *reinterpret_cast<uint32_t*>(buf + (row0 + 8 * i) * SROW + "
        "col * 2) =\n            bf16x2(fmaf(v0, sc.x, sh.x), fmaf(v1, "
        "sc.y, sh.y));", "        if (v0 == v1 + 1e30f) buf[0] = 1;")],
    "no_store": [(
        "      if (!tile_pixel(pl, p, b0, oy0, ox0, B, OH, OW, img, py, px)) "
        "continue;", "      if (B > 0) continue;")],
}
CUTS["skeleton"] = [c for name in ("no_dw", "no_mma", "no_epi", "no_store")
                    for c in CUTS[name]]


def variant_sources() -> dict:
    src = (kernels.CSRC / "acff.cu").read_text()
    out = {"whole": src}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old.strip()[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_all(sources: dict) -> dict:
    """Compile every variant in parallel; returns name -> launch function."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            kernels.nvcc_command(OUT / f"{name}.cu", OUT / f"lib{name}.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).acff_infer_launch
        fn.argtypes = ops.ACFF_KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    fns = build_all(variant_sources())
    rng = np.random.default_rng(0)
    card = card_line()
    result = {"card": card, "batch": BATCH, "ms": {}}
    for c, o, h in SHAPES:
        host = [rng.standard_normal((BATCH, h, h, c), dtype=np.float32),
                rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
                rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
                rng.normal(size=o), rng.uniform(0.5, 1.5, o),
                rng.normal(size=o)]
        a = [torch.from_numpy(v.astype(np.float32)).cuda() for v in host]
        a[0] = a[0].bfloat16()
        fuse_op = ops.pack_fuse_operand(a[3])
        plan = ops.tile_plan(BATCH, h, h)
        out = torch.empty((BATCH, h - 2, h - 2, o), dtype=torch.bfloat16,
                          device="cuda")
        times = {}
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(),
                        a[3].data_ptr(), fuse_op.data_ptr(), a[4].data_ptr(),
                        a[5].data_ptr(), a[6].data_ptr(), out.data_ptr(),
                        BATCH, h, h, c, o, 1, *plan.scalars(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            times[name] = graph_ms(call, 20)
        key = f"{h}x{h}x{c}->{o}"
        result["ms"][key] = times
        print(f"phases {key} batch {BATCH}: " + " ".join(
            f"{k}={v:.4f}" for k, v in times.items()) + f" ms [{card}]",
            flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
