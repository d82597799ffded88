#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's classifier engine on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, in order; any failure stops the script with a traceback and a
non-zero exit, and the result line is printed only at the end:
  1. device: the card's name, count and nvidia-smi name and power limit;
  2. build: the ACFF kernels, rtdm_tpu_torch/csrc/acff.cu, with nvcc's
     -Xptxas -v registers, shared memory and spills of both, and the count
     of tensor-core instructions (HGMMA, HMMA) that cuobjdump finds in the
     library; none fails the run;
  3. kernel vs plain: both ACFF kernels (bf16: wgmma, fp32: FMA) at every
     ACFF shape of the three classifiers, against their plain PyTorch
     version on the same inputs: checked at batch 1 and 3 (ragged and
     packed tiles) and checked and timed at engine batch 256, with bounds,
     share of the bound, and the bf16 kernel's shared memory and blocks
     per SM;
  4. end to end: the engines of artifacts/engines/ on the 10 example JPEGs,
     held against the port on the CPU and against the committed JAX golden
     (tests/goldens/torch_port/classifier_logits.npz), with the launch
     count of each ACFF kernel in each engine forward, each counted from 0;
  5. timing: Squeeze_ErNET bf16 engine latency at batch 1, 8 and 32 and
     frames/s at batch 256, with peak device memory, and a profiler
     breakdown by kernel of the batch-256 and the batch-1 call;
  6. one JSON line of kernels; then the last line, the result.

It imports nothing of JAX and nothing of the JAX package. It exits with
code 2 and no result without CUDA, or when run outside a checkout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "torch_port" / "classifier_logits.npz"
ENGINES = ROOT / "artifacts" / "engines"
MODELS = ("squeeze-ernet", "squeeze-redconv", "ernet")
BATCH = 256
SEED = 0
# H100 SXM, NVIDIA's data sheet: HBM rate, fp32 FMA rate outside the tensor
# cores, dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12}
# fp32: the bounds of tests/test_acff_pallas.py. bf16: kernel and plain both
# round the depthwise features and the output to bf16 (2^-8 relative each);
# a different summation order can move either rounding by one step.
KERNEL_TOL = {"fp32": (1e-4, 1e-5), "bf16": (2e-2, 2e-2)}
DESIGN = {"bf16": "wgmma", "fp32": "fma"}
KERNEL_NAME = {"bf16": "acff_bf16_kernel", "fp32": "acff_fp32_kernel"}
# engine logits, relative to max |logit| (tests/test_torch_engine.py)
LOGIT_REL_TOL = {"fp32": 1e-4, "bf16": 2e-2}
LIBRARY_NOTE = ("library_ms: n/a - no single PyTorch call computes the "
                "fused ACFF block (three dilated depthwise convs, concat, "
                "1x1 fuse, LeakyReLU, folded BN)")


def say(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of one ``fn`` call: ``iters`` calls captured in one
    CUDA graph, replayed and timed with CUDA events, so that the host's
    time to enqueue a call does not count (it does with ``cuda_ms`` when a
    call's kernels are shorter than its Python)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_ms(graph.replay, 3) / iters
    del graph
    return ms


def tensor_core_instructions(lib: Path) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    ops = re.findall(r"\b(HGMMA|HMMA)\.", sass)
    return {name: ops.count(name) for name in ("HGMMA", "HMMA")}


def acff_shapes(model: str):
    """(block, C, O, H, W) of every ACFF block on the model's main path,
    read off a forward with hooks."""
    from rtdm_tpu_torch.models import ACFF, create_model
    from rtdm_tpu_torch.models.ernet import input_size_for
    net = create_model(model, device="cuda")
    shapes = []
    for name, mod in net.named_modules():
        if isinstance(mod, ACFF):
            def hook(m, args, name=name):
                _, h, w, c = args[0].shape
                shapes.append((name, c, m.fused_conv.weight.shape[0], h, w))
            mod.register_forward_pre_hook(hook)
    s = input_size_for(model)
    with torch.inference_mode():
        net(torch.zeros(1, s, s, 3, device="cuda"))
    return shapes


def kernel_inputs(rng, b, c, o, h, w, dtype):
    """The seven arguments of ``acff_infer_plain`` on the card, x in
    ``dtype``, and fuse_w packed for the bf16 kernel as ``ACFF.packed()``
    packs it (None for fp32)."""
    eps = 1e-5
    gamma = rng.uniform(0.5, 1.5, o)
    beta, mean = rng.normal(size=o), rng.normal(size=o) * 0.1
    var = rng.uniform(0.5, 1.5, o)
    scale = gamma / np.sqrt(var + eps)
    host = [rng.standard_normal((b, h, w, c), dtype=np.float32),
            rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
            rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
            rng.normal(size=o), scale, beta - mean * scale]
    from rtdm_tpu_torch.ops.acff import pack_fuse_operand
    args = [torch.from_numpy(a.astype(np.float32)).cuda() for a in host]
    args[0] = args[0].to(dtype)
    fuse_op = pack_fuse_operand(args[3]) if dtype == torch.bfloat16 else None
    return args, fuse_op


def bound(b, c, o, h, w, quant):
    """Least time (ms) for one call: one read of x and of the weights the
    kernel reads, one write of out, against 2*P*(27C + 3C*O) operations.
    The depthwise weights and biases, fuse_b, scale and shift are fp32;
    fuse_w is fp32 (3C x O) for the fp32 kernel and bf16 (padded_k(C) x O,
    pack_fuse_operand) for the bf16 one."""
    from rtdm_tpu_torch.ops.acff import padded_k
    esize = 4 if quant == "fp32" else 2
    p = b * (h - 2) * (w - 2)
    fuse_bytes = 4 * 3 * c * o if quant == "fp32" else 2 * padded_k(c) * o
    nbytes = esize * (b * h * w * c + p * o) \
        + 4 * (27 * c + 3 * c + 3 * o) + fuse_bytes
    ops = 2 * p * (27 * c + 3 * c * o)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[quant]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def bf16_footprint(b, c, o, h, w):
    """(dynamic shared memory bytes, blocks per SM) of the bf16 kernel, as
    the library gives them; fails where the wrapper's own count of the
    bytes, which ``_check`` holds to the limit, disagrees."""
    from rtdm_tpu_torch.ops import kernels
    from rtdm_tpu_torch.ops.acff import bf16_smem_bytes, tile_plan
    lib = ctypes.CDLL(str(kernels.library_path("acff")))
    fn = lib.acff_bf16_footprint
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    pl = tile_plan(b, h, w)
    smem, per_sm = ctypes.c_int(), ctypes.c_int()
    rc = fn(c, o, pl.images * pl.hy * pl.hx * c * 2, ctypes.byref(smem),
            ctypes.byref(per_sm))
    if rc:
        raise RuntimeError(f"acff_bf16_footprint failed: CUDA error {rc}")
    counted = bf16_smem_bytes(c, o, pl)
    if smem.value != counted:
        raise AssertionError(f"C={c} O={o} H={h}: the kernel takes "
                             f"{smem.value} B of shared memory, "
                             f"bf16_smem_bytes counts {counted}")
    return smem.value, per_sm.value


def check_kernel(rng, b, c, o, h, w, quant, dtype, label):
    """The kernel against its plain version on one random input; returns
    the inputs and the largest absolute difference."""
    from rtdm_tpu_torch.ops.acff import acff_infer, acff_infer_plain
    args, fuse_op = kernel_inputs(rng, b, c, o, h, w, dtype)
    got = acff_infer(*args, fuse_op)
    torch.cuda.synchronize()
    want = acff_infer_plain(*args)
    rtol, atol = KERNEL_TOL[quant]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=lambda m: f"{label}: {m}")
    return args, fuse_op, (got.float() - want.float()).abs().max().item()


def phase_kernels(dtypes):
    """Phase 3: each kernel against its plain version at every main-path
    shape, at batch 1 and 3 (checked) and 256 (checked and timed); returns
    one record per (model, block, precision) at batch 256."""
    from rtdm_tpu_torch.ops.acff import acff_infer, acff_infer_plain
    rng = np.random.default_rng(SEED)
    records = []
    for model in MODELS:
        for block, c, o, h, w in acff_shapes(model):
            for quant, dtype in dtypes.items():
                label = f"{model}/{block} {quant}"
                small = {b: check_kernel(rng, b, c, o, h, w, quant, dtype,
                                         f"{label} batch {b}")[2]
                         for b in (1, 3)}
                args, fuse_op, err = check_kernel(
                    rng, BATCH, c, o, h, w, quant, dtype,
                    f"{label} batch {BATCH}")
                ms = graph_ms(lambda: acff_infer(*args, fuse_op), 20)
                plain_ms = graph_ms(lambda: acff_infer_plain(*args), 5)
                bound_ms, bound_by, nbytes, ops = bound(BATCH, c, o, h, w,
                                                        quant)
                rec = dict(model=model, block=block, quant=quant,
                           design=DESIGN[quant], x=[BATCH, h, w, c], o=o,
                           max_abs_err=err, max_abs_err_batch_1_3=small,
                           ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, share_of_bound=bound_ms / ms,
                           bytes=nbytes, ops=ops)
                extra = ""
                if quant == "bf16":
                    rec["smem_bytes"], rec["blocks_per_sm"] = bf16_footprint(
                        BATCH, c, o, h, w)
                    extra = (f" smem={rec['smem_bytes']} B "
                             f"blocks/SM={rec['blocks_per_sm']}")
                records.append(rec)
                say(f"kernel {label} ({DESIGN[quant]}) x=(256,{h},{w},{c}) "
                    f"O={o}: max_abs_err={err:.3e} (batch 1: "
                    f"{small[1]:.3e}, 3: {small[3]:.3e}) ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                    f"({bound_by}, {100 * bound_ms / ms:.1f}% of bound) "
                    f"library_ms=n/a{extra}")
                del args, fuse_op
    say(LIBRARY_NOTE)
    return records


def phase_end_to_end(frames, golden):
    """Phase 4: every engine on the card against the port on the CPU and
    the JAX golden. The launch counts of the ACFF kernels are set to 0 just
    before each engine forward and read just after it; returns, by path,
    the launches of the kernel of that path's precision."""
    from rtdm_tpu_torch.export.engine import Engine
    from rtdm_tpu_torch.ops.acff import ACFF_KERNEL, LAUNCHES
    launches = {}

    def counted(path, n_blocks, eng, x):
        quant = eng.spec.normalized_quant()
        ACFF_KERNEL.launches = 0
        LAUNCHES.update(bf16=0, fp32=0)
        out = eng(x)
        launches[path] = LAUNCHES[quant]
        want = {q: n_blocks if q == quant else 0 for q in LAUNCHES}
        if LAUNCHES != want or ACFF_KERNEL.launches != n_blocks:
            raise AssertionError(f"{path}: ACFF launches {LAUNCHES} for one "
                                 f"forward, expected {want}")
        return out

    for model in MODELS:
        x = frames[model]
        loaded = Engine.load(str(ENGINES / f"{model}_bf16"))
        n_blocks = sum(1 for n, _ in loaded.model.named_children()
                       if n.startswith("acff"))
        for quant in ("bf16", "fp32"):
            spec = dataclasses.replace(loaded.spec, quant=quant,
                                       with_softmax=False)
            eng = Engine(spec, loaded.variables)
            cpu = Engine(dataclasses.replace(spec, batch_size=16),
                         loaded.variables, device="cpu")
            logits = counted(f"{model}/{quant}", n_blocks, eng, x)
            want = cpu(x)
            tol = LOGIT_REL_TOL[quant] * np.abs(want).max()
            err = np.abs(logits - want).max()
            if not (np.all(np.isfinite(logits)) and err <= tol and
                    np.array_equal(logits.argmax(1), want.argmax(1))):
                raise AssertionError(f"{model} {quant}: card vs CPU logits "
                                     f"max |d|={err} > {tol} or argmax")
            say(f"e2e {model} {quant}: card vs port-on-CPU max|dlogit|="
                f"{err:.4e} (limit {tol:.4e}), argmax equal")
            if quant == "fp32":
                ref = golden[model]
                gl = counted(f"{model}/fp32 golden frames", n_blocks, eng,
                             golden[f"frames_{spec.image_size}"])
                gerr = np.abs(gl - ref).max()
                gtol = LOGIT_REL_TOL["fp32"] * np.abs(ref).max()
                if not (gerr <= gtol and
                        np.array_equal(gl.argmax(1), ref.argmax(1))):
                    raise AssertionError(f"{model} fp32: card vs JAX golden "
                                         f"max |d|={gerr} > {gtol} or argmax")
                say(f"e2e {model} fp32: card vs JAX golden max|dlogit|="
                    f"{gerr:.4e} (limit {gtol:.4e}), argmax equal")
        probs = counted(f"{model}/{loaded.spec.quant} engine dir", n_blocks,
                        loaded, x)
        if not (probs.shape == (len(x), loaded.spec.num_classes) and
                np.allclose(probs.sum(1), 1.0, atol=1e-3)):
            raise AssertionError(f"{model}: bad probabilities {probs}")
        say(f"e2e {model} {loaded.spec.quant} engine dir: classes "
            f"{probs.argmax(1).tolist()}")
    for path, n in launches.items():
        say(f"ACFF kernel launches ({KERNEL_NAME[path.split('/')[1][:4]]}), "
            f"one forward of {path}: {n}")
    return launches


def phase_timing(frames, card):
    """Phase 5: latency and throughput of the Squeeze_ErNET bf16 engine;
    returns the engine and frames of each batch size."""
    from rtdm_tpu_torch.export.engine import Engine
    loaded = Engine.load(str(ENGINES / "squeeze-ernet_bf16"))
    engines = {}
    for b in (1, 8, 32, 256):
        eng = Engine(dataclasses.replace(loaded.spec, batch_size=b),
                     loaded.variables)
        x = np.resize(frames["squeeze-ernet"], (b, 140, 140, 3))
        for _ in range(5):
            eng(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        samples = []
        for _ in range(100):
            t0 = time.perf_counter()
            eng(x)              # ends in a device-to-host copy: synchronised
            samples.append((time.perf_counter() - t0) * 1e3)
        samples.sort()
        med, p90 = samples[49], samples[89]
        device_ms = cuda_ms(lambda: eng.dispatch(x), 20)
        mem = torch.cuda.max_memory_allocated()
        say(f"latency squeeze-ernet bf16 batch {b}: median {med:.4f} ms, "
            f"p90 {p90:.4f} ms (n=100, host clock); device {device_ms:.4f} "
            f"ms/forward (CUDA events); peak memory {mem} B [{card}]")
        engines[b] = eng, x
    say(f"throughput squeeze-ernet bf16 batch 256: {256e3 / med:.1f} "
        f"frames/s (median) [{card}]")
    return engines


def phase_profile(eng, x, card, forwards=5):
    """Where one engine call's device time goes, by kernel
    (torch.profiler), and the device's busy share of the host-clock
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(forwards):
            eng(x)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        say("profile: the profiler recorded no device time; breakdown not "
            "measured")
        return
    say(f"profile squeeze-ernet bf16 batch {eng.spec.batch_size}, "
        f"{forwards} calls: device busy {busy / forwards:.1f} us/call of "
        f"{wall_us / forwards:.1f} us/call host clock "
        f"({100 * busy / wall_us:.1f}% busy) [{card}]")
    for us, n, name in rows[:12]:
        say(f"  {us / forwards:9.1f} us/call {100 * us / busy:5.1f}% "
            f"x{n // forwards} {name[:90]}")


def main() -> int:
    if not (ROOT / "rtdm_tpu_torch").is_dir() or not GOLDEN.exists():
        print("chip_smoke.py runs from the root of a checkout of the "
              "repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    say(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    say(f"card: {card}")

    # 2. build
    from rtdm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    log = kernels.build("acff")
    say(f"build: acff in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            say(f"  acff: {line.strip()}")
    counts = tensor_core_instructions(kernels.library_path("acff"))
    say(f"build: tensor-core instructions in the library (cuobjdump -sass): "
        f"{counts}")
    if not sum(counts.values()):
        raise AssertionError("the ACFF library has no HGMMA or HMMA "
                             "instruction")

    # 3. kernel vs plain
    records = phase_kernels({"fp32": torch.float32, "bf16": torch.bfloat16})

    # 4. end to end
    from rtdm_tpu_torch.cli.aider_predict import load_image_rgb, preprocess
    with np.load(GOLDEN) as g:
        golden = dict(g)
    examples = [ROOT / "docs" / "examples" / str(n) for n in golden["names"]]
    by_size = {}
    for s in (140, 240):
        by_size[s] = np.concatenate(
            [preprocess(load_image_rgb(str(p)), s) for p in examples])
        diff = np.abs(by_size[s].astype(int) - golden[f"frames_{s}"]).max()
        say(f"preprocess {s}: max |d| vs the golden's frames = {diff} "
            f"(PIL resampling of this machine)")
    frames = {m: by_size[240 if m == "ernet" else 140] for m in MODELS}
    launches = phase_end_to_end(frames, golden)

    # 5. timing
    engines = phase_timing(frames, card)
    for b in (256, 1):    # batch 1 is host-bound: its device busy share
        phase_profile(*engines[b], card)

    # 6. kernels line: one entry a kernel, summed over the ACFF blocks of
    # one forward of its main path (the Squeeze_ErNET engine of its
    # precision), launches counted in that forward
    main = {"bf16": "squeeze-ernet/bf16 engine dir",
            "fp32": "squeeze-ernet/fp32"}
    kernels_line = []
    for quant, path in main.items():
        rows = [r for r in records
                if r["model"] == "squeeze-ernet" and r["quant"] == quant]
        worst = max(rows, key=lambda r: r["bound_ms"])
        ms = sum(r["ms"] for r in rows)
        bound_ms = sum(r["bound_ms"] for r in rows)
        kernels_line.append({
            "name": KERNEL_NAME[quant], "route": "cuda",
            "source": "rtdm_tpu_torch/csrc/acff.cu",
            "replaces": "rtdm_tpu/ops/acff_pallas.py:43",
            "launches": launches[path],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": ms,
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound_ms,
            "bound_by": worst["bound_by"],
            "library_ms": None,
            "design": DESIGN[quant],
            "share_of_bound": bound_ms / ms,
            "sums_over": f"the ACFF blocks of one forward of {path} at "
                         f"batch {BATCH}",
            "launches_per_path": {p: n for p, n in launches.items()
                                  if p.split("/")[1].startswith(quant)},
            "per_shape": [r for r in records if r["quant"] == quant],
        })
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(f"card: {card}")
    say(json.dumps({"kernels": kernels_line}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
