#!/usr/bin/env python3
"""Where an ACFF kernel's time goes, by phase, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100:

    python3 scripts/acff_phase_times.py [--quant bf16|int8|int8_branch|fp32]
    python3 scripts/acff_phase_times.py --quant bf16_wide|int8_wide|\
        int8_branch_wide [--root CHECKOUT]

``ncu`` is not available everywhere the kernel is measured, so this times
variants of ``rtdm_tpu_torch/csrc/acff.cu`` with one phase removed each,
at the four Squeeze_ErNET ACFF shapes and Squeeze_RedConv's acff1 (C=8)
at batch 256: ``no_dw`` (no depthwise features), ``no_mma`` (no wgmma),
``no_epi`` (no epilogue into the staging tile), ``no_store`` (no output
stores) and ``skeleton`` (all four removed: box loads, barriers and loops
only). ``--quant int8`` runs the same cuts on the bf16 kernel's int8 QDQ
mode in its shared-box variant, and ``no_boxq`` (no QDQ pass over the
box; in ``skeleton`` too), ``--quant int8_branch`` the cuts of bf16 on
its per-branch variant, with act_scales that spread the codes over +-127
as ``chip_smoke.kernel_inputs`` makes them (equal for ``int8``, unequal
for ``int8_branch``). A variant computes garbage; only
its time means anything, and the
time a phase saves when removed is an upper bound on what it costs in the
whole kernel (the phases overlap across resident blocks). The fp32 kernel
(``--quant fp32``) has no ``no_epi`` (its epilogue stores from the
accumulators: ``no_store`` drops both) and has ``no_b`` (no B chunk
loads: the product reads
whatever the buffer holds), and variants of its arithmetic: ``one_tf32``
(the two lo terms removed: a single TF32 product, A_hi*B_hi) and
``chunk_runs`` (the tensor cores sum a whole channel chunk, each k step's
three terms in turn, before the fp32 add: the arithmetic of the first
3xTF32 design, in place of one k step a run). For those and ``whole`` it
prints max |out - fp64|
over max |fp64| on the random inputs beside ``chip_smoke.FP64_REL_TOL``
(the plain version computed in float64 on the card), and, on the inputs
each ACFF block of the three fp32 engines gets from the golden frames
(``chip_smoke.real_input_errors``), the largest error and the bias of
each block and the engines' logits against the JAX golden. Each variant is
a copy of the source edited by exact text replacement, built with
``kernels.nvcc_command`` (the port's flags) into ``build/phase_variants/``;
a replacement that no longer matches the source stops the script, so an
edit of those lines of the kernel is an edit of ``CUTS`` too. Times are
CUDA-graph replays (``chip_smoke.graph_ms``). Prints one line per shape
and a JSON object.

The wide-C variant (``--quant bf16_wide``, ``int8_wide``,
``int8_branch_wide``: ``acff_bf16_wide_kernel`` in each mode) runs its own
cuts at ``chip_smoke.WIDE_SHAPES`` (batch 256): ``no_dw`` (no depthwise
features), ``no_mma`` (no wgmma), ``no_b`` (no B chunk loads: the product
reads whatever the buffers hold), ``no_store`` (no output stores),
``skeleton`` (all four removed) and, for ``int8_wide``, ``no_boxq`` (no
QDQ pass over the box; in ``skeleton`` too). ``--root`` names the checkout
whose ``csrc/acff.cu`` and ``rtdm_tpu_torch`` (its tile plan and packed
operand) are measured, by default this one, so that two commits can be
timed in turns in one call on one card; the cuts are those of the design
the source holds (``WIDE_CUTS``: "serial", one 64-pixel tile a block with
every chunk's phases in turn; "pipelined", warp-specialised; the text of
each cut must occur once). ``--only whole`` (or any list of variant
names, comma-separated) builds and times those alone.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _root() -> Path:
    """The checkout named by ``--root`` (read before the imports below, so
    that ``rtdm_tpu_torch`` comes from it)."""
    args = sys.argv[1:]
    for i, a in enumerate(args):
        if a == "--root" and i + 1 < len(args):
            return Path(args[i + 1]).resolve()
        if a.startswith("--root="):
            return Path(a.split("=", 1)[1]).resolve()
    return ROOT


MEASURED = _root()
sys.path.insert(0, str(MEASURED))
from rtdm_tpu_torch.ops import acff as ops, kernels  # noqa: E402

# chip_smoke from this checkout; the package stays the measured one's
sys.path.insert(0, str(ROOT))
from chip_smoke import (BRANCH_SPREAD, DTYPES, ENGINES,  # noqa: E402
                        FP64_REL_TOL, GOLDEN, MODELS, WIDE_SHAPES,
                        acff_inputs, card_line, eager_forward, graph_ms,
                        real_input_errors)

OUT = ROOT / "build" / "phase_variants" / MEASURED.name
SHAPES = [(16, 64, 69), (8, 64, 69), (64, 96, 33), (96, 128, 15),
          (128, 256, 6)]
BATCH = 256
CUTS = {
    "no_dw": [(
        "      if (C >= 48) dw_rows<8, QM>(box, wts, a_s, C, kp8, tid, qd);\n"
        "      else if (C >= 16) dw_rows<4, QM>(box, wts, a_s, C, kp8, tid, "
        "qd);\n"
        "      else dw_rows<2, QM>(box, wts, a_s, C, kp8, tid, qd);\n", "")],
    "no_mma": [("for (int s = 0; s < kc / 16; ++s)",
                "for (int s = 0; s < 0; ++s)")],
    "no_epi": [(
        "        *reinterpret_cast<uint32_t*>(buf + (row0 + 8 * i) * SROW + "
        "col * 2) =\n            bf16x2(fmaf(v.x, sc.x, sh.x), fmaf(v.y, "
        "sc.y, sh.y));", "        if (v.x == v.y + 1e30f) buf[0] = 1;")],
    "no_store": [(
        "      if (!tile_pixel(pl, p, b0, oy0, ox0, B, OH, OW, img, py, px)) "
        "continue;\n      __nv_bfloat16* dst =",
        "      if (B > 0) continue;\n      __nv_bfloat16* dst =")],
}
CUTS["skeleton"] = [c for name in ("no_dw", "no_mma", "no_epi", "no_store")
                    for c in CUTS[name]]
# the shared-box QDQ variant: the same cuts, and its pass over the box
BOXQ = [("for (int i = tid; i < box_bytes / 16; i += BTHREADS) {",
         "for (int i = tid; i < 0; i += BTHREADS) {")]
CUTS_INT8 = {**CUTS, "no_boxq": BOXQ, "skeleton": CUTS["skeleton"] + BOXQ}
# the fp32 kernel's product of one channel chunk
PRODUCT = ("      if (KC == 16)\n"
           "        chunk_product<NH, 6>(acc, a_base, b_base, L.apart, "
           "L.bsz / 2, a_sbo,\n"
           "                             b_sbo);\n"
           "      else\n"
           "        chunk_product<NH, 3>(acc, a_base, b_base, L.apart, "
           "L.bsz / 2, a_sbo,\n"
           "                             b_sbo);\n")
CUTS_FP32 = {
    "no_dw": [
        ("          dw_rows_f32<4>(box, wts, a_s, L.apart, KC, L.kc4, tid);",
         "          ;"),
        ("          dw_rows_f32<2>(box, wts, a_s, L.apart, KC, L.kc4, tid);",
         "          ;"),
        ("for (int i = tid; i < 3 * BM * KC4; i += BTHREADS) {",
         "for (int i = tid; i < 0; i += BTHREADS) {")],
    "no_mma": [(PRODUCT, "")],
    "no_b": [("    if (uses > 0) issue_b(0);\n", ""),
             ("      mbar_wait(bar_b, nchunks > 1 ? (u & 1) : 0);\n", ""),
             ("      if (tid == 0 && nchunks > 1 && u + 1 < uses) "
              "issue_b((c + 1) % nchunks);\n", "")],
    "no_store": [("        if (dst[i] != nullptr)\n",
                  "        if (B < 0)\n")],
}
CUTS_FP32["skeleton"] = [c for name in ("no_dw", "no_mma", "no_store")
                         for c in CUTS_FP32[name]]
CUTS_FP32["one_tf32"] = [(
    "  wgmma_tf32<P>(d, gmma_desc(a + apart, F_LBO, a_sbo),\n"
    "                gmma_desc(b, 128, b_sbo), 0);\n"
    "  wgmma_tf32<P>(d, gmma_desc(a, F_LBO, a_sbo),\n"
    "                gmma_desc(b + blo, 128, b_sbo), 1);\n"
    "  wgmma_tf32<P>(d, gmma_desc(a, F_LBO, a_sbo), "
    "gmma_desc(b, 128, b_sbo), 1);\n",
    "  (void)apart; (void)blo;\n"
    "  wgmma_tf32<P>(d, gmma_desc(a, F_LBO, a_sbo), "
    "gmma_desc(b, 128, b_sbo), 0);\n")]


# the first 3xTF32 design's arithmetic: each k step's three terms in turn,
# summed over the whole chunk on the tensor cores before the fp32 add
CUTS_FP32["chunk_runs"] = [(PRODUCT, """\
      {
        float part[NH / 2];
        fence_operands(part);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        for (int s = 0; s < 3 * KC / 8; ++s) {
          const uint32_t ao = a_base + 2 * s * F_LBO;
          const uint32_t bo = b_base + 2 * s * 128;
          wgmma_tf32<NH>(part, gmma_desc(ao + L.apart, F_LBO, a_sbo),
                         gmma_desc(bo, 128, b_sbo), s > 0);
          wgmma_tf32<NH>(part, gmma_desc(ao, F_LBO, a_sbo),
                         gmma_desc(bo + L.bsz / 2, 128, b_sbo), 1);
          wgmma_tf32<NH>(part, gmma_desc(ao, F_LBO, a_sbo),
                         gmma_desc(bo, 128, b_sbo), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        retire_run<0>(acc, part);
      }
""")]
ACCURACY = ("whole", "one_tf32", "chunk_runs")


def wide_cut_set(design: str, quant: str) -> dict:
    """The cuts of ``design`` run for ``quant``, with ``skeleton``, and
    ``no_boxq`` (in ``skeleton`` too) in the shared-box QDQ mode alone,
    where the pass runs."""
    cuts, boxq = WIDE_CUTS[design]
    out = dict(cuts)
    out["skeleton"] = [c for name in ("no_dw", "no_mma", "no_b", "no_store")
                       for c in cuts[name]]
    if quant == "int8_wide":
        out["no_boxq"] = boxq
        out["skeleton"] = out["skeleton"] + boxq
    return out


# The cuts of each design of the wide-C variant, and its no_boxq cut.
# "serial": one 64-pixel tile a block, every 32-channel chunk's phases in
# turn (box, QDQ pass, depthwise into one A, product, wait) by all 256
# threads.
WIDE_CUTS = {
    "serial": ({
        "no_dw": [("        dw_rows<4, QM>(box, wts, a_s, WKC, KP8, tid, "
                   "qd);\n", "")],
        "no_mma": [("for (int s = 0; s < K / 16; ++s)",
                    "for (int s = 0; s < 0; ++s)")],
        "no_b": [("      issue_b(u);\n", ""),
                 ("* K * 16;\n      mbar_wait(bar_b + 8 * (u & 1), (u >> 1) "
                  "& 1);\n", "* K * 16;\n"),
                 ("      if (tid == 0 && u + 2 < uses) issue_b(u + 2);\n",
                  "")],
        "no_store": [("        if (dst[i])\n", "        if (B < 0)\n")],
    }, [("for (int i = tid; i * 16 < box_bytes; i += BTHREADS) {",
         "for (int i = tid; i < 0; i += BTHREADS) {")]),
    # "pipelined": 128 (O = 256: 64) pixels a block, depthwise warps
    # filling two A buffers while two MMA warpgroups run the product
    "pipelined": ({
        "no_dw": [("""\
          if (warp < NQ)
            wide_dw_row<0, 8, QM>(box, wts, a_s, WHX, q, py, 0, qd);
          else if (warp < 2 * NQ)
            wide_dw_row<1, 8, QM>(box, wts, a_s, WHX, q, py, 0, qd);
          else
            wide_dw_row<2, 8, QM>(box, wts, a_s, WHX, q, py, 0, qd);
""", "          (void)py;\n"), ("""\
          wide_dw_row<0, 4, QM>(box, wts, a_s, WHX, q, py, px0, qd);
          wide_dw_row<1, 4, QM>(box, wts, a_s, WHX, q, py, px0, qd);
          wide_dw_row<2, 4, QM>(box, wts, a_s, WHX, q, py, px0, qd);
""", "          (void)q; (void)py; (void)px0;\n")],
        "no_mma": [("for (int k = 0; k < WK / 16; ++k)",
                    "for (int k = 0; k < 0; ++k)")],
        "no_b": [("    for (int u = 0; u < NB && u < uses; ++u) issue_b(u);\n",
                  ""),
                 ("      mbar_wait(full_b + 8 * sb, pb);\n", ""),
                 ("      if (r + NB < uses) issue_b(r + NB);\n", "")],
        "no_store": [("      if (keep)\n", "      if (B < 0)\n")],
    }, [("for (int i = dt; i * 16 < box_bytes; i += WDW) {",
         "for (int i = dt; i < 0; i += WDW) {")]),
}


def wide_design(src: str) -> str:
    """The design in ``WIDE_CUTS`` whose every cut text occurs once in
    ``src``."""
    for name, (cuts, boxq) in WIDE_CUTS.items():
        if all(src.count(old) == 1
               for c in [*cuts.values(), boxq] for old, _ in c):
            return name
    raise SystemExit("no design of WIDE_CUTS matches the wide-C variant "
                     "in this source")


def variant_sources(cuts_by_name: dict, src: str) -> dict:
    out = {"whole": src}
    for name, cuts in cuts_by_name.items():
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


def real_inputs(fns: dict) -> dict:
    """Each variant of ``fns`` in place of the built kernel, in the three
    fp32 engines on the golden frames: per model, the largest error and
    the bias of each block on the inputs the production kernel's forward
    gave it, and the engine's logits against the JAX golden."""
    from rtdm_tpu_torch.export.engine import Engine
    with np.load(GOLDEN) as g:
        golden = dict(g)
    kern = ops.ACFF_KERNEL
    kern._bind()
    whole, result = kern._fn, {}
    for model in MODELS:
        loaded = Engine.load(str(ENGINES / f"{model}_bf16"))
        spec = dataclasses.replace(loaded.spec, quant="fp32",
                                   with_softmax=False)
        eng = Engine(spec, loaded.variables)
        frames, want = golden[f"frames_{spec.image_size}"], golden[model]
        with acff_inputs(eng.model, len(want)) as blocks:
            eager_forward(eng, frames)
        for name, fn in fns.items():
            kern._fn = fn
            try:
                rows = real_input_errors(blocks)
                err = float(np.abs(eager_forward(eng, frames) - want).max())
            finally:
                kern._fn = whole
            top = float(np.abs(want).max())
            result.setdefault(name, {})[model] = {
                "logit_err": err, "logit_rel_err": err / top, "blocks": rows}
            print(f"real inputs {name} {model}: logits vs JAX golden "
                  f"{err:.4e} ({err / top:.3e} of max |logit|); per block "
                  f"kernel max / bias (plain max / bias): " + ", ".join(
                      f"{r['block']} {r['kernel_max']:.2e} / "
                      f"{r['kernel_bias']:.2e} ({r['plain_max']:.2e} / "
                      f"{r['plain_bias']:.2e})" for r in rows), flush=True)
        del eng, blocks
    return result


def wide_plan(b: int, h: int, w: int, o: int):
    """The tile plan the measured checkout's wrapper launches the wide-C
    variant on (checkouts without ``wide_tile_plan`` ran it on
    ``tile_plan``)."""
    plan = getattr(ops, "wide_tile_plan", None)
    return plan(b, h, w, o) if plan is not None else ops.tile_plan(b, h, w)


def wide_times(quant: str, fns: dict, card: str) -> dict:
    """Each variant's time at every shape of ``WIDE_SHAPES``, batch
    ``BATCH``, through the C entry with the measured checkout's packed
    operand and tile plan."""
    rng = np.random.default_rng(0)
    times = {}
    for c, o, h in WIDE_SHAPES:
        host = [rng.standard_normal((BATCH, h, h, c), dtype=np.float32),
                rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
                rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
                rng.normal(size=o), rng.uniform(0.5, 1.5, o),
                rng.normal(size=o)]
        a = [torch.from_numpy(v.astype(np.float32)).cuda() for v in host]
        a[0] = a[0].bfloat16()
        fuse_op = ops.pack_fuse_operand_wide(a[3])
        plan = wide_plan(BATCH, h, h, o)
        qs = [0.0] * 4
        if quant != "bf16_wide":
            s_x = a[0].float().abs().max().item() / 127
            spread = (BRANCH_SPREAD if quant == "int8_branch_wide"
                      else (1.0,) * 3)
            feat = ops.depthwise_features(*a[:3])
            qs = [s_x * f for f in spread] + [feat.abs().max().item() / 127]
        out = torch.empty((BATCH, h - 2, h - 2, o), dtype=torch.bfloat16,
                          device="cuda")
        key = f"{h}x{h}x{c}->{o}"
        times[key] = {}
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(),
                        fuse_op.data_ptr(), a[4].data_ptr(), a[5].data_ptr(),
                        a[6].data_ptr(), out.data_ptr(), BATCH, h, h, c, o,
                        ops.MODES[quant], o, *plan.scalars(), *qs,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name} launch failed: CUDA error "
                                       f"{rc}")
            times[key][name] = graph_ms(call, 20)
        print(f"phases {quant} {key} batch {BATCH} ({MEASURED.name}): "
              + " ".join(f"{k}={v:.4f}" for k, v in times[key].items())
              + f" ms [{card}]", flush=True)
        del a, fuse_op, out
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quant", choices=tuple(ops.MODES), default="bf16")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose kernel is measured")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time")
    args = ap.parse_args()
    quant = args.quant
    only = None if args.only is None else set(args.only.split(","))
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    src = (kernels.CSRC / "acff.cu").read_text()
    card = card_line()
    if quant.endswith("_wide"):
        design = wide_design(src)
        sources = variant_sources(wide_cut_set(design, quant), src)
        fns = build_all({k: v for k, v in sources.items()
                         if only is None or k in only})
        print(json.dumps({"card": card, "quant": quant, "batch": BATCH,
                          "root": MEASURED.name, "design": design,
                          "ms": wide_times(quant, fns, card)}))
        return 0
    bf16 = quant != "fp32"
    sources = variant_sources(
        CUTS_INT8 if quant == "int8" else CUTS if bf16 else CUTS_FP32, src)
    fns = build_all({k: v for k, v in sources.items()
                     if only is None or k in only})
    rng = np.random.default_rng(0)
    dtype = DTYPES[quant]
    result = {"card": card, "quant": quant, "batch": BATCH, "ms": {}}
    for c, o, h in SHAPES:
        host = [rng.standard_normal((BATCH, h, h, c), dtype=np.float32),
                rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
                rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
                rng.normal(size=o), rng.uniform(0.5, 1.5, o),
                rng.normal(size=o)]
        a = [torch.from_numpy(v.astype(np.float32)).cuda() for v in host]
        a[0] = a[0].to(dtype)
        fuse_op = (ops.pack_fuse_operand(a[3]) if bf16
                   else ops.pack_fuse_operand_tf32(a[3]))
        plan = ops.tile_plan(BATCH, h, h)
        qs = [0.0] * 4
        if quant.startswith("int8"):
            s_x = a[0].float().abs().max().item() / 127
            spread = BRANCH_SPREAD if quant == "int8_branch" else (1.0,) * 3
            feat = ops.depthwise_features(*a[:3])
            qs = [s_x * f for f in spread] + [feat.abs().max().item() / 127]
        out = torch.empty((BATCH, h - 2, h - 2, o), dtype=dtype,
                          device="cuda")
        times, errors = {}, {}
        ref = None if bf16 else ops.acff_infer_plain(*[t.double() for t in a])
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(),
                        fuse_op.data_ptr(), a[4].data_ptr(), a[5].data_ptr(),
                        a[6].data_ptr(), out.data_ptr(), BATCH, h, h, c, o,
                        ops.MODES[quant], o, *plan.scalars(), *qs,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            times[name] = graph_ms(call, 20)
            if ref is not None and name in ACCURACY:
                call()
                torch.cuda.synchronize()
                errors[name] = ((out.double() - ref).abs().max()
                                / ref.abs().max()).item()
        key = f"{h}x{h}x{c}->{o}"
        result["ms"][key] = times
        if errors:
            result.setdefault("fp64_rel_err", {})[key] = errors
            print(f"fp64 {key}: " + " ".join(
                f"{k}={v:.3e} ({'pass' if v <= FP64_REL_TOL else 'FAIL'})"
                for k, v in errors.items()) + f" of max |out|, limit "
                f"{FP64_REL_TOL}", flush=True)
        print(f"phases {quant} {key} batch {BATCH}: " + " ".join(
            f"{k}={v:.4f}" for k, v in times.items()) + f" ms [{card}]",
            flush=True)
        del a, fuse_op, out, ref
    if not bf16:
        result["real_inputs"] = real_inputs({k: fns[k] for k in ACCURACY
                                             if k in fns})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
