#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's classifier and detector engines on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, in order; any failure stops the script with a traceback and a
non-zero exit, and the result line is printed only at the end:
  1. device: the card's name, count and nvidia-smi name and power limit;
  2. build: the ACFF kernels, rtdm_tpu_torch/csrc/acff.cu, with nvcc's
     -Xptxas -v registers, shared memory and spills of both, and the count
     of tensor-core instructions (HGMMA, HMMA, and the HGMMA on TF32) that
     cuobjdump finds in the library; no bf16 or no TF32 HGMMA fails the
     run;
  3. kernel vs plain: both ACFF kernels (bf16: wgmma, fp32: 3xTF32 on
     wgmma) and the bf16 kernel's int8 QDQ mode in both its variants (the
     box QDQ'd once, at equal branch scales; QDQ'd per branch, at unequal
     ones) at every ACFF shape of the three classifiers, against their
     plain PyTorch version on the same inputs (QDQ: scales that spread the
     codes over +-127): checked at batch 1 and 3 (ragged and packed tiles)
     and checked and timed at engine batch 256, the fp32 kernel timed at
     batch 1 too and held to the plain version computed in float64
     (FP64_REL_TOL), with bounds (fp32: the 3xTF32 and the FMA-peak one;
     QDQ: bf16's, QDQ adds no bytes), share of the bound, and each
     kernel's shared memory (checked against the wrapper's count), blocks
     per SM and registers; at equal scales the per-branch variant, reached
     through the C entry, must give the shared one's output bit for bit;
     each main-path call must make exactly one launch of its kernel (the
     shape takes the kernel as it is). Then ROADMAP fault 2: the shapes the
     reference kernel takes and the kernels as they are do not
     (FAULT2_SHAPES: C 3, 12, 150, 300; O 1, 32, 100, 320; H = W 3 and
     300; 65537 images), each mode, through acff_decomposed and the wide-C
     variant with the launches they must make, against the plain version;
     and the wide-C variant (all three modes) timed at C = 160 and 256 (O
     = 128, batch 256, 8x8 tiles) with its shared memory, registers and
     share of its bound;
  4. end to end: the engines of artifacts/engines/ (bf16, fp32 from the
     same weights, int8) on the 10 example JPEGs, held against the port on
     the CPU and against the committed JAX goldens
     (tests/goldens/torch_port/classifier_logits.npz, fp32;
     classifier_int8_logits.npz, int8), with the launch count of each ACFF
     kernel in each engine forward, each counted from 0; the fp32 kernel,
     on the inputs each ACFF block of the fp32 engines gets from the
     golden frames, against the plain version in float64: its largest
     error (FP64_REL_TOL) and its mean signed error (BIAS_TOL), beside the
     plain fp32 version's; the QDQ mode on the inputs each block of the
     int8 engines gets, against its plain version, the int8 engines
     launching only the shared-box variant; and a Squeeze_ErNET
     int8 engine calibrated on the card from the golden frames by both
     methods, its act_scales against the port's on the CPU (CALIB_RTOL);
  5. timing: Squeeze_ErNET bf16 engine latency at batch 1, 8 and 32 and
     frames/s at batch 256, its fp32 and int8 engines at batch 1 and 256,
     with peak device memory, and a profiler breakdown by kernel of the
     bf16 batch-256 and batch-1 calls and the int8 batch-256 call;
  6. detection: both committed int8 detector engines
     (artifacts/engines/{yolov4-tiny,yolov5s}-mini_int8) loaded on the card
     at their stored batch of 16, on the 10 letterboxed golden frames
     repeated to the batch, held against the port on the CPU and the JAX
     golden (tests/goldens/torch_port/detector_int8.npz) by
     rtdm_tpu_torch.eval.detection's gates, with each run's NMS candidates
     (yolov4-tiny with equal counts in every frame too), no ACFF launch in a
     detector
     forward, decode and NMS on the card bit-equal to the CPU on the same
     inputs; latency at batch 1 and 16 (median and p90 of 100 calls),
     frames/s at 16, peak memory, and a profiler breakdown of the batch-16
     call (upload, /255, network: convs and int8 QDQ, decode, top-k sort,
     the NMS fixpoint with its steps, download);
  7. detection CLIs (PIL only: no cv2, no matplotlib): yolo_detect
     --engine on both detectors over docs/examples, on the card and the
     CPU, held to each other and to the JAX golden
     (tests/goldens/torch_port/detect_cli.npz) by compare_detections in
     letterbox pixels (yolov4-tiny with equal counts in every frame), no
     ACFF launch; the same with the --classify squeeze-ernet veto: 4 bf16
     ACFF launches a frame with a detection, and every decision unlike the
     golden's at a near tie of its logits (VETO_TIE), counted; yolo_test
     on the labelled example set (data/example_set.py) for both engines in
     bf16 and int8 and yolov5s with --rect, P/R/mAP@0.5 within
     METRIC_TOL of the CPU port's, rect bucket shapes equal to the CPU's,
     images/s; yolo_detect ms/frame at batch 1 with and without the veto
     (median and p90 over TIMED_FRAMES frames after WARM_FRAMES);
  8. streaming, cascade and serving, from torch's TF32 defaults (cuDNN
     TF32 on): rtdm-serve on 127.0.0.1 with a Squeeze_ErNET fp32 engine
     and the yolov4-tiny-mini int8 detector, both endpoints driven at once
     by run_load (SERVE_CLIENTS x SERVE_REQUESTS, the example JPEGs as
     bodies, decoded natively), every classify reply held to the lone
     direct fp32 call
     (SERVE_PROB_TOL) and every detect reply equal to the direct Detector
     call, a control that runs the fp32 model under tf32(True) and must
     miss the fp32 logit gate, /stats, and run_direct's decode, handler and
     core rates for the fp32, bf16 and int8 classifiers and the detector;
     realtime_inference --engine squeeze-ernet_bf16 --power over the
     examples looped to REALTIME_FRAMES at REALTIME_BATCHES, labels equal
     to direct Engine calls on the same cv2-resized frames, FPS, ms/batch
     and modelled mJ/frame at the card's power limit; cascade_stream in
     bf16 and fp32 at 416 on the golden frames (yolov4-tiny-mini's cfg,
     its seeded init checked against the golden's digest) against the
     port on the CPU and tests/goldens/torch_port/cascade.npz
     (CASCADE_REL_TOL, detections by compare_detections with
     CASCADE_BOX_REL), 4 ACFF launches of the frame's precision a frame,
     ms/frame median and p90; AutoShape over both detectors on the
     examples as paths and arrays, equal to the Detector plus the
     un-letterbox; the ACFF launches of every one of these paths;
  9. training (rtdm_tpu_torch/train/, cli/aider_train.py): the three cases
     of tests/goldens/torch_port/train.npz (the JAX train step, three
     steps of Squeeze_ErNET at 140 from one init on one batch of 16: fp32
     sgd, fp32 adamw, bf16 adamw) on the card against the golden and the
     port on the CPU (TRAIN_GATES), with a control (weight decay on
     BatchNorm's scale too) that must miss case a's gate; train_model on
     an AIDER-style hue-separable set written under build/chip_smoke/aider
     (AIDER_SPLITS images of AIDER_SIDE^2): fp32 at batch 32 doubled to 64
     for 3 epochs without augmentation (the loss falls, val_acc >= 0.4)
     and bf16 with the defaults (albumentations-style augmentations,
     mixup and cutmix) for 1 epoch (finite losses), each run's ACFF
     launches counted from 0: 4 of the policy's kernel a validation or
     test batch, none in a train step; on the trained weights the
     kernels against the blocks run layer by layer (fp32 and bf16 logit
     gates) and ROADMAP fault 4 (evaluate, step, evaluate again: the
     second eval sees the new weights); the Engine built from the trained
     .npz against the port on the CPU on the golden frames; the train step
     at batch 64 and 256 in fp32 and bf16 (median, p90, images/s, peak
     memory), the eval step, and a profiler split of one bf16 step at
     batch 256;
 10. detector training (rtdm_tpu_torch/cli/yolo_train.py and what it
     runs): the three cases of tests/goldens/torch_port/yolo_train.npz (the
     JAX detector train step, three steps from the committed detectors'
     dequantized weights on the 10 example frames at 416: yolov5s-mini fp32
     with v5 SGD and EMA, yolov4-tiny-mini fp32 with burn-in and two
     microbatches, yolov5s-mini bf16) on the card against the golden and
     the port on the CPU (YOLO_GATES), with two controls on case a that
     must miss: BatchNorm at torch's momentum 0.1 (ROADMAP fault 8) and a
     last-write-wins tobj (or no colliding cell); yolo_train on a synthetic
     set written by data/synth.py under build/chip_smoke/synth
     (SYNTH_SPLITS): yolov5s-mini at 416, batch 16 of nominal 64, 3 epochs
     with EMA, mosaic and BN burn-in 2, then --resume to a 4th epoch, and
     yolov4-tiny-mini 1 epoch --rect and 1 --multi-scale (finite losses,
     the mAP computed, 0 ACFF launches each), best.npz served by
     build_detector on the card; the train step of yolov5s-mini at 416 in
     fp32 and bf16 at batch 16 and 64 (accumulate 4), the loader's images/s
     with mosaic, a profiler split of one bf16 step and the eval pass's
     ms/image;
 11. native host IO (rtdm_tpu_torch/data/native_io.py,
     csrc/rtdm_io.cpp): (a) with phase 2, the host library built by g++
     beside the nvcc build (the command, the libjpeg it linked and that
     library's version), which must load: the PIL fallback fails the run;
     (b) after phase 10, on the 10 example JPEGs, the square and rect
     letterbox decodes, decode_batch and DetectionDataset.load_scaled at
     416 and 208, held to tests/goldens/torch_port/native_io.npz (sha256
     digests, shapes, gains, pads, original sizes: bit-equal), and the
     served classify frames at 140 through rtdm-serve's classify service
     on the bf16 Squeeze_ErNET engine: every class equal to the JAX
     server's (the probability margins printed; 4 bf16 ACFF launches a
     batch, counted from 0); then host rates, native against PIL in this
     run: the mosaic loader's images/s at 416 on 8 threads on phase 10's
     synthetic JPEGs, serve_loadtest's decode_ms for classify and detect,
     load_detector_calib_images' images/s; phase 10's loader and phase
     8's rtdm-serve requests/s beside their figures with PIL from before
     the native decode was wired in (PERF.md);
 12. multi-GPU (rtdm_tpu_torch/core/mesh.py, parallel/, the mesh of
     Engine, the trainers and the checkpoints; on the one card, so
     nothing here runs on two), on MULTI_FRAMES (crops of the example
     photos, whose rows' outputs differ): (b) first, which of gloo's own
     collectives take CUDA tensors (GLOO_PROBE_OPS, each in two
     processes on the card), joined before anything is timed; (a) NCCL
     at world size 1 in this process, where a mesh line of one rank has
     no group and the data-parallel paths run no collective: the
     Squeeze_ErNET bf16, fp32 and int8 engines at batch 256 with a mesh,
     bit-equal to the engine without one, 4 ACFF launches of the
     engine's precision a forward counted from 0, host ms with and
     without the mesh; the data-parallel classifier step (golden case a)
     and yolov5s-mini step (golden case a, first step) against the steps
     without a mesh (MULTI_STEP_TOL, YOLO_GATES); NCCL itself, called
     directly on the group of one: the all-reduce of the classifier's
     gradients and the all-gather of the engine's output, checked and
     timed; the legs of __graft_entry__.dryrun_multichip at world size 1
     (classifier DP for 10 steps with the loss falling, in turns with the
     same steps without a mesh, both timed and their losses held
     together; YOLO DP, the halo conv, serving DP, the elastic save and
     resume); (c) MULTI_RANKS gloo ranks that share the card (the port
     stages CUDA tensors through the host for gloo): the three engines
     at batch 256 bit-equal to engines of batch 256 / MULTI_RANKS run on
     each rank's rows here (and their gap to (a)'s whole batch
     reported) with each rank's 4 ACFF launches, both train steps
     against (a)'s, the halo conv against the plain conv, and the
     elastic ladder 2 -> 1 (this process resumes the ranks' checkpoint)
     within rtol 2e-3 of their continuation;
 13. tooling (models/torch_import.py, the darknet and v5 loaders, the
     v5 block zoo, the tool CLIs, export/serialize.py with the ACFF block
     as the registered op rtdm::acff_infer): (a) the three Squeeze_ErNET
     engines' trees written as the reference's .pt state dict, loaded by
     load_variables and served by Engines on the card, bit-equal to the
     .npz engines on the golden frames with 4 ACFF launches a forward;
     (b) yolov4-tiny-mini .npz -> save_darknet_weights ->
     load_darknet_weights -> Detector, detections equal to the .npz
     detector's, and pth_to_weights .npz -> .weights -> .npz; (c)
     yolov5s-mini through a v5-layout {'model', 'ema'} .pt (EMA
     preferred), detections equal to the .npz detector's, and an nc=80
     head refused, then skipped with intersect; (d) every zoo block in one
     yaml (ZOO_YAML) at width 0.50, 416^2, seeded init, on the card
     against the CPU port in fp32 with TF32 off (ZOO_TOL); (e)
     profile_model on yolov5s-mini at 416^2, batch 1 (its table printed);
     (f) export_model --dynamic-batch of the three Squeeze_ErNET engines,
     loaded back and run at EXPORT_BATCHES bit-equal to the eager engine,
     4 ACFF launches a forward through the loaded program, and of the
     yolov4-tiny detector at 416^2 bit-equal to its eager forward; (g)
     build_int8_engines on both detector cfgs calibrated on phase 10's
     synthetic JPEGs, act_scales equal to build_engine's; (h)
     Engine.__call__ host medians at EXPORT_BATCHES through the op and
     through the wrapper called directly, in turns; the phase's times;
 14. one JSON line of kernels; then the last line, the result.

It imports nothing of JAX and nothing of the JAX package. It exits with
code 2 and no result without CUDA, or when run outside a checkout.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "torch_port" / "classifier_logits.npz"
GOLDEN_INT8 = GOLDEN.with_name("classifier_int8_logits.npz")
GOLDEN_DET = GOLDEN.with_name("detector_int8.npz")
GOLDEN_CLI = GOLDEN.with_name("detect_cli.npz")
GOLDEN_CASCADE = GOLDEN.with_name("cascade.npz")
DETECTORS = ("yolov4-tiny-mini_int8", "yolov5s-mini_int8")
CONV_KERNEL = re.compile(r"conv|cudnn|xmma|implicit|gemm|sm90_|sm80_",
                         re.IGNORECASE)
ENGINES = ROOT / "artifacts" / "engines"
MODELS = ("squeeze-ernet", "squeeze-redconv", "ernet")
BATCH = 256
SEED = 0
# H100 SXM, NVIDIA's data sheet: HBM rate, fp32 FMA rate outside the tensor
# cores, dense bf16 and TF32 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12}
# fp32: the bounds of tests/test_acff_pallas.py. bf16: kernel and plain both
# round the depthwise features and the output to bf16 (2^-8 relative each);
# a different summation order can move either rounding by one step. The
# int8 QDQ mode (both variants) is held to ``int8_limit``.
KERNEL_TOL = {"fp32": (1e-4, 1e-5), "bf16": (2e-2, 2e-2)}
DESIGN = {"bf16": "wgmma", "fp32": "3xtf32-wgmma",
          "int8": "wgmma-qdq-shared-box", "int8_branch": "wgmma-qdq-branch"}
KERNEL_NAME = {"bf16": "acff_bf16_kernel", "fp32": "acff_fp32_kernel",
               "int8": "acff_bf16_kernel_qdq",
               "int8_branch": "acff_bf16_kernel_qdq_branch",
               "bf16_wide": "acff_bf16_wide_kernel",
               "int8_wide": "acff_bf16_wide_kernel_qdq",
               "int8_branch_wide": "acff_bf16_wide_kernel_qdq_branch"}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "int8": torch.bfloat16, "int8_branch": torch.bfloat16}
# ROADMAP fault 2: shapes the reference kernel takes and the kernels as
# they are do not (acff_decomposed, the wide-C variant): (batch, C, O, H=W)
FAULT2_CHANNELS = (3, 12, 150, 300)
FAULT2_OUTPUTS = (1, 32, 100, 320)
FAULT2_SHAPES = ([(2, c, o, 3) for c in FAULT2_CHANNELS
                  for o in FAULT2_OUTPUTS]
                 + [(1, c, o, 300) for c, o in zip(FAULT2_CHANNELS,
                                                   FAULT2_OUTPUTS)]
                 + [(65537, 1, 32, 3)])
# the wide-C variant timed at batch 256 on 8x8 tiles (16x16 outputs)
WIDE_SHAPES = ((160, 128, 18), (256, 128, 18))
# detection CLIs (phase 7): the veto classifier, the labelled set's batch,
# the frames timed at batch 1 (the 10 examples repeated) and the warm-up
# frames left out of the timing
VETO = ("squeeze-ernet", ENGINES / "squeeze-ernet_bf16" / "params.npz")
CLI_BATCH = 10
TIMED_FRAMES = 50
WARM_FRAMES = 2
# yolo_test on the card against the CPU port, within one detection of
# about 57: mAP@0.5, and P and R for the v3 family (taken at conf 0.1),
# the mean F1 for v5 (P and R are taken at the confidence of the best
# mean F1, which a flipped detection can move to another near-equal
# peak: tests/test_torch_yolo_test.py); the int8 yolov5s, whose
# detections move most with the conv summation order, within two
# detections on the F1 (0.0207 from JAX on the CPU)
METRIC_TOL = 0.02
V5_INT8_F1_TOL = 0.04
# a veto decision may differ where the classifier's two top logits lie
# within this share of max |logit|
VETO_TIE = 1e-2
# the depthwise scales of the per-branch QDQ variant's inputs, as factors
# of max |x| / 127: unequal, and one branch clips
BRANCH_SPREAD = (1.0, 0.7, 1.3)
# fp32 kernel against the plain version computed in float64, relative to
# max |out|: full fp32 accuracy (3xTF32 reaches ~1e-6; one TF32 product,
# hi*hi, ~1e-4, which fails)
FP64_REL_TOL = 1e-5
# The fp32 kernel on the inputs its blocks get from real frames: the mean
# of (out - fp64) * sign(fp64) over mean |fp64|. Rounding toward zero, as
# the tensor cores round the sums they carry, makes it negative, and such
# a bias does not average away in the next block's sums as rounding to
# nearest does; random N(0, 1) inputs, centred on zero, do not show it.
BIAS_TOL = 1e-7
# engine logits, relative to max |logit| (tests/test_torch_engine.py). int8:
# below the smallest top-2 margin of the JAX int8 logits on the golden
# frames (2.9% of max |logit|, ErNET); the port on the CPU is bit-exact.
LOGIT_REL_TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 3e-2}
# phase 8: rtdm-serve's load (clients x sequential requests each, both
# endpoints at once); a served fp32 reply against the lone direct call,
# relative to max |prob| (bit-equal where a row does not depend on the
# batch it rode in); realtime_inference's batches; the cascade's
# probabilities against the CPU port and the JAX golden, relative to max
# |prob| (tests/test_torch_streaming.py), and its timed frames after the
# warm-up
SERVE_CLIENTS = 16
SERVE_REQUESTS = 8
SERVE_PROB_TOL = 1e-6
REALTIME_BATCHES = (1, 8)
REALTIME_FRAMES = 100   # the examples looped: FPS past the loop's start
CASCADE_REL_TOL = {"fp32": 1e-4, "bf16": 2e-2}
# the cascade's detector has random weights, whose boxes are not on the
# scale of the frame: in bf16 a corner may move this share of the box's
# longer side beyond BOX_PX (a bf16 rounding flip moves one by up to 4.4%:
# tests/test_torch_detector.py BOX_REL); fp32 none
CASCADE_BOX_REL = {"fp32": 0.0, "bf16": 0.06}
CASCADE_WARM = 5
CASCADE_TIMED = 50
# act_scales calibrated on the card against the port on the CPU
# (tests/test_torch_quant.py holds the port's against JAX's)
CALIB_RTOL = {"percentile": 1e-4, "entropy": 1e-2}
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


def _count_from_zero():
    """Set every ACFF launch count to 0."""
    from rtdm_tpu_torch.ops.acff import ACFF_KERNEL, LAUNCHES
    ACFF_KERNEL.launches = 0
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


def _only(kind, n):
    """The launch counts of a run that launched ``n`` of ``kind`` only."""
    from rtdm_tpu_torch.ops.acff import LAUNCHES
    return {k: n if k == kind else 0 for k in LAUNCHES}


def _read_launches(path, launches, want=None):
    """Record the launches counted since ``_count_from_zero`` under
    ``path``; fail unless they are ``want`` (if given)."""
    from rtdm_tpu_torch.ops.acff import ACFF_KERNEL, LAUNCHES
    got = dict(LAUNCHES)
    launches[path] = got
    if want is not None and (got != want or ACFF_KERNEL.launches
                             != sum(want.values())):
        raise AssertionError(f"{path}: ACFF launches {got}, expected {want}")
    return got


def _percentiles(ms):
    """(median, p90) of the samples."""
    ms = sorted(ms)
    return ms[(len(ms) - 1) // 2], ms[int(0.9 * len(ms)) - 1]


def tensor_core_instructions(lib: Path) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in a built library,
    and the HGMMA ones that take TF32 operands."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    ops = re.findall(r"\b(HGMMA|HMMA)\.", sass)
    counts = {name: ops.count(name) for name in ("HGMMA", "HMMA")}
    counts["HGMMA_TF32"] = len(re.findall(r"\bHGMMA\.\S*TF32", sass))
    return counts


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


def kernel_inputs(rng, b, c, o, h, w, quant, operands=False):
    """The seven arguments of ``acff_infer_plain`` on the card, x in the
    dtype of ``quant``, fuse_w packed for the kernel of that precision
    (with ``operands``, as ``FuseOperands``, which ``ACFF.packed()``
    holds: every shape; else the packed tensor of a shape the kernel takes
    as it is), and for int8 the act_scales: s_x = max |x| /
    127 for the three branches ("int8_branch": times ``BRANCH_SPREAD``)
    and s_f = max |features| / 127 of the plain version's bf16 features,
    so that the codes spread over +-127."""
    eps = 1e-5
    gamma = rng.uniform(0.5, 1.5, o)
    beta, mean = rng.normal(size=o), rng.normal(size=o) * 0.1
    var = rng.uniform(0.5, 1.5, o)
    scale = gamma / np.sqrt(var + eps)
    host = [rng.standard_normal((b, h, w, c), dtype=np.float32),
            rng.normal(size=(3, 3, 3, c)) * 0.3, rng.normal(size=(3, c)),
            rng.normal(size=(3 * c, o)) / np.sqrt(3 * c),
            rng.normal(size=o), scale, beta - mean * scale]
    from rtdm_tpu_torch.ops.acff import (FuseOperands, depthwise_features,
                                         pack_fuse_operand,
                                         pack_fuse_operand_tf32)
    dtype = DTYPES[quant]
    args = [torch.from_numpy(a.astype(np.float32)).cuda() for a in host]
    args[0] = args[0].to(dtype)
    pack = (pack_fuse_operand if dtype == torch.bfloat16
            else pack_fuse_operand_tf32)
    qs = None
    if quant.startswith("int8"):
        s_x = args[0].float().abs().max().item() / 127
        spread = BRANCH_SPREAD if quant == "int8_branch" else (1.0,) * 3
        feat = depthwise_features(*args[:3])
        qs = tuple(s_x * f for f in spread) + (feat.abs().max().item() / 127,)
    if operands:
        return args, FuseOperands(args[3], dtype), qs
    return args, pack(args[3]), qs


def bound(b, c, o, h, w, route):
    """Least time (ms) for one call, the larger of its bytes over 3.35 TB/s
    and its operations over the peak of the units that run them; returns
    (ms, "bytes" or "operations", bytes, operations).

    Bytes: one read of x and of the weights, one write of out. The
    depthwise weights and biases, fuse_b, scale and shift are fp32; fuse_w
    is bf16 K-padded as the bf16 kernel reads it (``pack_fuse_operand``)
    for "bf16", and fp32 (3C x O, read once) for "3xtf32" and "fma": the
    function needs it at fp32 only, and the fp32 kernel's split into hi
    and lo is its own choice. Operations, 2*P*(27C + 3C*O): all at the bf16
    tensor-core rate for "bf16"; all at the fp32 FMA rate for "fma"; for
    "3xtf32" the depthwise at the FMA rate and the fuse product three
    times over at the TF32 tensor-core rate, as separate floors."""
    from rtdm_tpu_torch.ops.acff import padded_k
    esize = 2 if route == "bf16" else 4
    p = b * (h - 2) * (w - 2)
    fuse_bytes = 2 * padded_k(c) * o if route == "bf16" else 4 * 3 * c * o
    nbytes = esize * (b * h * w * c + p * o) \
        + 4 * (27 * c + 3 * c + 3 * o) + fuse_bytes
    dw_ops, fuse_ops = 2 * p * 27 * c, 2 * p * 3 * c * o
    if route == "3xtf32":
        ops = dw_ops + 3 * fuse_ops
        t_ops = max(dw_ops / PEAK_OPS_PER_S["fp32"],
                    3 * fuse_ops / PEAK_OPS_PER_S["tf32"])
    else:
        ops = dw_ops + fuse_ops
        t_ops = ops / PEAK_OPS_PER_S["bf16" if route == "bf16" else "fp32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def footprint(quant, b, c, o, h, w):
    """(dynamic shared memory bytes, blocks per SM, registers a thread) of
    the kernel (or QDQ variant) of ``quant``, as the library gives them;
    fails where the wrapper's own count of the bytes (``bf16_smem_bytes`` /
    ``fp32_smem_bytes``), which ``_check`` holds to the limit, disagrees."""
    from rtdm_tpu_torch.ops import kernels
    from rtdm_tpu_torch.ops.acff import (MODES, bf16_smem_bytes,
                                         bf16_wide_smem_bytes,
                                         fp32_smem_bytes, tile_plan)
    lib = ctypes.CDLL(str(kernels.library_path("acff")))
    pl = tile_plan(b, h, w)
    smem, per_sm, regs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    out = [ctypes.byref(smem), ctypes.byref(per_sm), ctypes.byref(regs)]
    if quant == "fp32":
        fn = lib.acff_fp32_footprint
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
        rc = fn(c, o, pl.images, pl.hy, pl.hx, *out)
        counted = fp32_smem_bytes(c, o, pl)
    elif quant.endswith("_wide"):
        fn = lib.acff_bf16_wide_footprint
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
        rc = fn(o, pl.images, pl.hy, pl.hx, MODES[quant], *out)
        counted = bf16_wide_smem_bytes(o, pl)
    else:
        fn = lib.acff_bf16_footprint
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
        rc = fn(c, o, pl.images * pl.hy * pl.hx * c * 2, MODES[quant], *out)
        counted = bf16_smem_bytes(c, o, pl)
    if rc:
        raise RuntimeError(f"{quant} footprint failed: CUDA error {rc}")
    if smem.value != counted:
        raise AssertionError(f"{quant} C={c} O={o} H={h}: the kernel takes "
                             f"{smem.value} B of shared memory, the wrapper "
                             f"counts {counted}")
    return smem.value, per_sm.value, regs.value


def check_kernel(rng, b, c, o, h, w, quant, label):
    """The kernel against its plain version on one random input; returns
    the inputs (with the packed operand and the act_scales), the largest
    absolute difference, and both outputs."""
    args, fuse_op, qs = kernel_inputs(rng, b, c, o, h, w, quant)
    err, got, want = hold_to_plain(args, fuse_op, qs, quant, label)
    return (args, fuse_op, qs), err, got, want


def int8_limit(qs, args, want):
    """The QDQ mode's largest difference from its plain version, by
    output, and its part that does not depend on the output (one int8
    code). A depthwise sum taken in another order can round to the other
    bf16 neighbour and so QDQ to the next code (1 in 10^4 to 10^7
    features), which moves the fuse product by up to s_f * max |fuse_w| and
    an output by up to s_f * max |fuse_w * scale|, whatever the output's
    own size; then the pre-BN value v, rounded to bf16 twice (the product,
    the bias sum), can land a step of 2^-7 |v| further each, which is
    2^-7 |out - shift| in the output, and the output a step of 2^-7 |out|.
    args are ``acff_infer_plain``'s (x, dw_w, dw_b, fuse_w, fuse_b, scale,
    shift)."""
    one_code = qs[3] * (args[3] * args[5]).abs().max().item()
    want = want.float()
    return one_code + 2.0 ** -7 * (want.abs() + 2 * (want - args[6]).abs()), \
        one_code


def hold_to_plain(args, fuse_op, qs, quant, label, expect=None):
    """One call of the kernel of ``quant`` against the plain version on
    the same inputs (``KERNEL_TOL``; with act_scales ``qs``,
    ``int8_limit``); fails unless the call made the launches ``expect``
    ({LAUNCHES key: count}; by default one launch of ``quant``: the shape
    takes the kernel as it is); returns (largest absolute difference,
    kernel output, plain output)."""
    from rtdm_tpu_torch.ops.acff import LAUNCHES, acff_infer, acff_infer_plain
    before = dict(LAUNCHES)
    got = acff_infer(*args, fuse_op, act_scales=qs)
    torch.cuda.synchronize()
    made = {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}
    if made != (expect or {quant: 1}):
        raise AssertionError(f"{label}: launches {made}, expected "
                             f"{expect or {quant: 1}}")
    want = acff_infer_plain(*args, act_scales=qs)
    diff = (got.float() - want.float()).abs()
    if qs is None:
        rtol, atol = KERNEL_TOL[quant]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{label}: {m}")
    else:
        limit, _ = int8_limit(qs, args, want)
        over = diff > limit
        if over.any():
            i = tuple(torch.nonzero(over)[0].tolist())
            raise AssertionError(
                f"{label}: {int(over.sum())} outputs over the int8 limit, "
                f"e.g. at {i}: kernel {got[i].item()} plain {want[i].item()}"
                f" limit {limit[i].item():.4e}")
    return diff.max().item(), got, want


def branch_equals_shared(args, fuse_op, qs, got, label):
    """The per-branch QDQ variant, launched through the C entry at the
    equal scales ``qs`` that made the shared-box variant's output ``got``,
    must give that output bit for bit: QDQ of the box once in shared
    memory is exact (a comparison launch: no ``LAUNCHES`` count)."""
    from rtdm_tpu_torch.ops.acff import ACFF_KERNEL, MODES, tile_plan
    b, h, w, c = args[0].shape
    o = args[3].shape[-1]
    out = torch.empty_like(got)
    ACFF_KERNEL.launch(
        args[0].data_ptr(), *(a.data_ptr() for a in args[1:3]),
        fuse_op.data_ptr(), *(a.data_ptr() for a in args[4:7]),
        out.data_ptr(), b, h, w, c, o, MODES["int8_branch"], o,
        *tile_plan(b, h, w).scalars(), *qs,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int16), got.view(torch.int16)):
        n = (out.view(torch.int16) != got.view(torch.int16)).sum().item()
        raise AssertionError(f"{label}: the per-branch variant differs from "
                             f"the shared-box one at equal scales in {n} "
                             f"outputs")


def fp64_errors(args, got, want, label):
    """(max |kernel - fp64|, max |plain fp32 - fp64|, max |fp64|) with the
    plain version computed in float64 on the card; fails where the
    kernel's error is above FP64_REL_TOL of max |fp64|."""
    from rtdm_tpu_torch.ops.acff import acff_infer_plain
    ref = acff_infer_plain(*[a.double() for a in args])
    k_err = (got.double() - ref).abs().max().item()
    p_err = (want.double() - ref).abs().max().item()
    top = ref.abs().max().item()
    del ref
    if not k_err <= FP64_REL_TOL * top:
        raise AssertionError(f"{label}: max |kernel - fp64| = {k_err:.3e} "
                             f"> {FP64_REL_TOL} x max |out| ({top:.3e})")
    return k_err, p_err, top


@contextlib.contextmanager
def acff_inputs(net, n):
    """Collects, in forward order, (name, block, x) for every ACFF block of
    ``net`` that runs inside the ``with``: x is a copy of the first ``n``
    images of the block's input (forward pre-hooks; no kernel launch)."""
    from rtdm_tpu_torch.models import ACFF
    seen = []

    def hook(mod, args, name):
        seen.append((name, mod, args[0][:n].clone()))
    hooks = [mod.register_forward_pre_hook(
        lambda m, args, name=name: hook(m, args, name))
        for name, mod in net.named_modules() if isinstance(mod, ACFF)]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def real_input_errors(blocks):
    """The fp32 kernel on each block's real input (``acff_inputs``) against
    the plain version in fp32 and in float64 on the card. Per block, for
    the kernel and for the plain fp32 version: max |out - fp64| over max
    |fp64| ("max") and the mean of (out - fp64) * sign(fp64) over mean
    |fp64| ("bias")."""
    from rtdm_tpu_torch.ops.acff import acff_infer, acff_infer_plain
    rows = []
    for name, mod, x in blocks:
        args = mod.packed()
        got = acff_infer(x, *args)
        want = acff_infer_plain(x, *args[:6])
        ref = acff_infer_plain(x.double(), *args[:6])
        sign, mean = ref.sign(), ref.abs().mean().item()
        row = {"block": name, "x": list(x.shape),
               "max_abs_out": ref.abs().max().item()}
        for who, out in (("kernel", got), ("plain", want)):
            d = out.double() - ref
            row[f"{who}_max"] = d.abs().max().item() / row["max_abs_out"]
            row[f"{who}_bias"] = (d * sign).mean().item() / mean
        del got, want, ref, sign
        rows.append(row)
    return rows


def phase_kernels(quants):
    """Phase 3: each kernel (and the bf16 one's int8 QDQ mode, both
    variants) against its plain version at every main-path shape, at batch
    1 (checked and timed), 3 (checked) and 256 (checked, timed, and for
    fp32 held to the float64 plain version; for the shared-box QDQ variant
    the per-branch one at the same scales held to it bit for bit, at each
    batch); returns one record per (model, block, precision) at batch
    256."""
    from rtdm_tpu_torch.ops.acff import acff_infer, acff_infer_plain
    rng = np.random.default_rng(SEED)
    records = []
    for model in MODELS:
        for block, c, o, h, w in acff_shapes(model):
            for quant in quants:
                label = f"{model}/{block} {quant}"
                small, ms_1 = {}, None
                for b in (1, 3):
                    (args, fuse_op, qs), small[b], got, _ = check_kernel(
                        rng, b, c, o, h, w, quant, f"{label} batch {b}")
                    if quant == "int8":
                        branch_equals_shared(args, fuse_op, qs, got,
                                             f"{label} batch {b}")
                    if b == 1:
                        ms_1 = graph_ms(lambda: acff_infer(
                            *args, fuse_op, act_scales=qs), 20)
                (args, fuse_op, qs), err, got, want = check_kernel(
                    rng, BATCH, c, o, h, w, quant, f"{label} batch {BATCH}")
                if quant == "int8":
                    branch_equals_shared(args, fuse_op, qs, got,
                                         f"{label} batch {BATCH}")
                ms = graph_ms(lambda: acff_infer(*args, fuse_op,
                                                 act_scales=qs), 20)
                plain_ms = graph_ms(lambda: acff_infer_plain(
                    *args, act_scales=qs), 5)
                route = "3xtf32" if quant == "fp32" else "bf16"
                bound_ms, bound_by, nbytes, ops = bound(BATCH, c, o, h, w,
                                                        route)
                rec = dict(model=model, block=block, quant=quant,
                           design=DESIGN[quant], x=[BATCH, h, w, c], o=o,
                           max_abs_err=err, max_abs_err_batch_1_3=small,
                           ms=ms, ms_batch_1=ms_1, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           share_of_bound=bound_ms / ms, bytes=nbytes,
                           ops=ops)
                extra = ""
                rec["smem_bytes"], rec["blocks_per_sm"], rec["registers"] = \
                    footprint(quant, BATCH, c, o, h, w)
                if quant.startswith("int8"):
                    rec["differing_share"] = (got != want).float().mean(
                    ).item()
                    rec["act_scales"] = list(qs)
                    extra = (f" outputs differing from plain: "
                             f"{100 * rec['differing_share']:.4f}%")
                if quant == "int8":
                    rec["branch_bit_equal"] = True
                    extra += " per-branch variant bit-equal at these scales"
                if quant == "fp32":
                    fma = bound(BATCH, c, o, h, w, "fma")
                    rec.update(fma_bound_ms=fma[0], fma_bound_by=fma[1],
                               fma_share_of_bound=fma[0] / ms)
                    k64, p64, top = fp64_errors(args, got, want, label)
                    rec.update(fp64_err=k64, plain_fp64_err=p64,
                               fp64_max_abs_out=top)
                    extra = (f" fma_bound_ms={fma[0]:.4f} ({fma[1]}, "
                             f"{100 * fma[0] / ms:.1f}%) vs fp64: kernel "
                             f"{k64:.3e} plain {p64:.3e} (max|out| "
                             f"{top:.3e}, limit {FP64_REL_TOL * top:.3e})")
                extra += (f" smem={rec['smem_bytes']} B "
                          f"blocks/SM={rec['blocks_per_sm']} "
                          f"regs={rec['registers']}")
                records.append(rec)
                say(f"kernel {label} ({DESIGN[quant]}) x=(256,{h},{w},{c}) "
                    f"O={o}: max_abs_err={err:.3e} (batch 1: "
                    f"{small[1]:.3e}, 3: {small[3]:.3e}) ms={ms:.4f} "
                    f"ms_batch_1={ms_1:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bound_ms:.4f} ({bound_by}, "
                    f"{100 * bound_ms / ms:.1f}% of bound) "
                    f"library_ms=n/a{extra}")
                del args, fuse_op, got, want
    say(LIBRARY_NOTE)
    return records


def int8_real_input_errors(blocks):
    """The QDQ mode on each block's real input from an int8 engine
    (``acff_inputs``), as the block hands it to the kernel
    (``ACFF.kernel_input``), against the plain version (``int8_limit``):
    per block the largest difference, the limit and the share of outputs
    that differ."""
    from rtdm_tpu_torch.ops.acff import qdq_variant
    rows = []
    for name, mod, x in blocks:
        xk = mod.kernel_input(x)
        args = (xk, *mod.packed())
        err, got, want = hold_to_plain(
            args[:7], args[7], mod.act_scales,
            qdq_variant(mod.act_scales), f"int8 real input {name}")
        one_code = int8_limit(mod.act_scales, args, want)[1]
        rows.append({"block": name, "x": list(xk.shape),
                     "max_abs_out": want.float().abs().max().item(),
                     "max_abs_err": err, "limit_one_code": one_code,
                     "differing_share": (got != want).float().mean().item()})
    return rows


def phase_end_to_end(frames, golden, golden_int8):
    """Phase 4: every engine on the card against the port on the CPU and
    the JAX golden of its precision; the fp32 kernel on the inputs each
    block of the fp32 engines gets from the golden frames
    (``real_input_errors``), and the QDQ mode on those each block of the
    int8 engines gets (``int8_real_input_errors``). The launch counts of
    the ACFF kernels are set to 0 just before each engine forward and read
    just after it; returns, by path, the launches of the kernel of that
    path's precision, and the real-input rows by precision."""
    from rtdm_tpu_torch.export.engine import Engine
    from rtdm_tpu_torch.ops.acff import ACFF_KERNEL, LAUNCHES
    launches, real = {}, {"fp32": [], "int8": []}

    def counted(path, n_blocks, eng, x):
        quant = eng.spec.normalized_quant()
        _count_from_zero()
        out = eng(x)
        launches[path] = LAUNCHES[quant]
        want = {q: n_blocks if q == quant else 0 for q in LAUNCHES}
        if LAUNCHES != want or ACFF_KERNEL.launches != n_blocks:
            raise AssertionError(f"{path}: ACFF launches {LAUNCHES} for one "
                                 f"forward, expected {want}")
        return out

    def against(logits, want, quant, what):
        tol = LOGIT_REL_TOL[quant] * np.abs(want).max()
        err = np.abs(logits - want).max()
        if not (np.all(np.isfinite(logits)) and err <= tol and
                np.array_equal(logits.argmax(1), want.argmax(1))):
            raise AssertionError(f"{what}: max |d|={err} > {tol} or argmax")
        say(f"e2e {what} max|dlogit|={err:.4e} (limit {tol:.4e}, "
            f"{err / np.abs(want).max():.3e} of max|logit|), argmax equal")

    def engine_dir(model, quant, loaded, x):
        path = f"{model}/{quant} engine dir"
        probs = counted(path, n_blocks, loaded, x)
        if not (probs.shape == (len(x), loaded.spec.num_classes) and
                np.allclose(probs.sum(1), 1.0, atol=1e-3)):
            raise AssertionError(f"{path}: bad probabilities {probs}")
        say(f"e2e {path}: classes {probs.argmax(1).tolist()}")

    for model in MODELS:
        x = frames[model]
        loaded = Engine.load(str(ENGINES / f"{model}_bf16"))
        n_blocks = sum(1 for n, _ in loaded.model.named_children()
                       if n.startswith("acff"))
        gx = golden[f"frames_{loaded.spec.image_size}"]
        for quant in ("bf16", "fp32"):
            spec = dataclasses.replace(loaded.spec, quant=quant,
                                       with_softmax=False)
            eng = Engine(spec, loaded.variables)
            cpu = Engine(dataclasses.replace(spec, batch_size=16),
                         loaded.variables, device="cpu")
            against(counted(f"{model}/{quant}", n_blocks, eng, x), cpu(x),
                    quant, f"{model} {quant}: card vs port-on-CPU")
            if quant == "fp32":
                with acff_inputs(eng.model, len(gx)) as blocks:
                    gl = counted(f"{model}/fp32 golden frames", n_blocks,
                                 eng, gx)
                against(gl, golden[model], "fp32",
                        f"{model} fp32: card vs JAX golden")
                for row in real_input_errors(blocks):
                    real["fp32"].append({"model": model, **row})
                    say(f"real inputs {model}/{row['block']} x={row['x']}: "
                        f"vs fp64, of max|out| {row['max_abs_out']:.3e}: "
                        f"kernel {row['kernel_max']:.3e}, plain "
                        f"{row['plain_max']:.3e}; bias, of mean|out|: "
                        f"kernel {row['kernel_bias']:.3e}, plain "
                        f"{row['plain_bias']:.3e} (limits {FP64_REL_TOL}, "
                        f"{BIAS_TOL})")
                    if not (row["kernel_max"] <= FP64_REL_TOL
                            and abs(row["kernel_bias"]) <= BIAS_TOL):
                        raise AssertionError(
                            f"{model}/{row['block']}: the fp32 kernel on "
                            f"real inputs is outside its limits")
                del blocks
        engine_dir(model, "bf16", loaded, x)

        # int8: the committed engine directory, its logits against the port
        # on the CPU and the JAX int8 golden
        loaded = Engine.load(str(ENGINES / f"{model}_int8"))
        spec = dataclasses.replace(loaded.spec, with_softmax=False)
        eng = Engine(spec, loaded.variables, loaded.act_scales)
        cpu = Engine(dataclasses.replace(spec, batch_size=16),
                     loaded.variables, loaded.act_scales, device="cpu")
        against(counted(f"{model}/int8", n_blocks, eng, x), cpu(x), "int8",
                f"{model} int8: card vs port-on-CPU")
        with acff_inputs(eng.model, len(gx)) as blocks:
            gl = counted(f"{model}/int8 golden frames", n_blocks, eng, gx)
        against(gl, golden_int8[model], "int8",
                f"{model} int8: card vs JAX int8 golden")
        for row in int8_real_input_errors(blocks):
            real["int8"].append({"model": model, **row})
            say(f"real inputs {model}/{row['block']} int8 x={row['x']}: "
                f"QDQ mode vs plain max|d| {row['max_abs_err']:.3e} (one "
                f"code {row['limit_one_code']:.3e} + 2^-7 (|out| + 2 |out - "
                f"shift|); max|out| "
                f"{row['max_abs_out']:.3e}), outputs differing "
                f"{100 * row['differing_share']:.4f}%")
        del blocks
        engine_dir(model, "int8", loaded, x)
    for path, n in launches.items():
        quant = path.split("/")[1].split()[0]
        say(f"ACFF kernel launches ({KERNEL_NAME[quant]}), one forward of "
            f"{path}: {n}" + (f" (and {KERNEL_NAME['int8_branch']}: 0)"
                               if quant == "int8" else ""))
    return launches, real


def phase_calibration(golden):
    """Phase 4, calibration: the Squeeze_ErNET int8 engine built on the
    card from the golden frames by both methods; its act_scales against
    the port's on the CPU (``CALIB_RTOL``)."""
    from rtdm_tpu_torch.export.engine import build_engine
    from rtdm_tpu_torch.models.io import load_variables
    variables = load_variables(str(ENGINES / "squeeze-ernet_int8" /
                                   "params.npz"))
    frames = golden["frames_140"]
    rows = {}
    for method in ("percentile", "entropy"):
        t0 = time.perf_counter()
        card = build_engine("squeeze-ernet", variables, "int8", batch_size=16,
                            calib_images=frames, calib_method=method)
        card_s = time.perf_counter() - t0
        cpu = build_engine("squeeze-ernet", variables, "int8", batch_size=16,
                           calib_images=frames, calib_method=method,
                           verify=False, device="cpu")
        a, b = card.act_scales, cpu.act_scales
        if sorted(a) != sorted(b):
            raise AssertionError(f"calibration {method}: keys differ")
        rel = max(abs(float(a[k]) - float(b[k])) / float(b[k]) for k in a)
        if not rel <= CALIB_RTOL[method]:
            raise AssertionError(f"calibration {method}: card vs CPU act "
                                 f"scales differ by {rel:.3e} relative > "
                                 f"{CALIB_RTOL[method]}")
        rows[method] = {"keys": len(a), "max_rel_diff": rel,
                        "card_build_s": card_s}
        say(f"calibration squeeze-ernet {method} on the card ({len(frames)} "
            f"frames, build {card_s:.2f} s): {len(a)} scales, max rel "
            f"diff vs port-on-CPU {rel:.3e} (limit {CALIB_RTOL[method]})")
    return rows


def phase_timing(frames, card):
    """Phase 5: latency of the Squeeze_ErNET bf16 engine at batch 1, 8, 32
    and 256 (frames/s at 256), of its fp32 engine at batch 1 and 256 and
    of its int8 engine (the committed directory's weights and act_scales)
    at batch 1 and 256; returns {(quant, batch): (engine, frames)} for the
    bf16 and int8 engines."""
    from rtdm_tpu_torch.export.engine import Engine
    engines = {}
    for quant, batches in (("bf16", (1, 8, 32, 256)), ("fp32", (1, 256)),
                           ("int8", (1, 256))):
        loaded = Engine.load(str(ENGINES / ("squeeze-ernet_int8"
                                            if quant == "int8" else
                                            "squeeze-ernet_bf16")))
        for b in batches:
            eng = Engine(dataclasses.replace(loaded.spec, quant=quant,
                                             batch_size=b), loaded.variables,
                         loaded.act_scales)
            x = np.resize(frames["squeeze-ernet"], (b, 140, 140, 3))
            for _ in range(5):
                eng(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            samples = []
            for _ in range(100):
                t0 = time.perf_counter()
                eng(x)          # ends in a device-to-host copy: synchronised
                samples.append((time.perf_counter() - t0) * 1e3)
            samples.sort()
            med, p90 = samples[49], samples[89]
            device_ms = cuda_ms(lambda: eng.dispatch(x), 20)
            mem = torch.cuda.max_memory_allocated()
            say(f"latency squeeze-ernet {quant} batch {b}: median {med:.4f} "
                f"ms, p90 {p90:.4f} ms (n=100, host clock); device "
                f"{device_ms:.4f} ms/forward (CUDA events); peak memory "
                f"{mem} B [{card}]")
            if quant != "fp32":
                engines[quant, b] = eng, x
        say(f"throughput squeeze-ernet {quant} batch 256: {256e3 / med:.1f} "
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
    say(f"profile squeeze-ernet {eng.spec.normalized_quant()} batch "
        f"{eng.spec.batch_size}, "
        f"{forwards} calls: device busy {busy / forwards:.1f} us/call of "
        f"{wall_us / forwards:.1f} us/call host clock "
        f"({100 * busy / wall_us:.1f}% busy) [{card}]")
    for us, n, name in rows[:12]:
        say(f"  {us / forwards:9.1f} us/call {100 * us / busy:5.1f}% "
            f"x{n // forwards} {name[:90]}")


def detector_latency(det, x, card, label):
    """Host-clock latency of ``det(x)`` (upload, forward, download), median
    and p90 of 100 calls after 5 warm-up calls, and the peak device
    memory; returns the median ms."""
    for _ in range(5):
        det(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    samples = []
    for _ in range(100):
        t0 = time.perf_counter()
        det(x)               # ends in a device-to-host copy: synchronised
        samples.append((time.perf_counter() - t0) * 1e3)
    med, p90 = _percentiles(samples)
    say(f"latency {label} batch {len(x)}: median {med:.4f} ms, p90 "
        f"{p90:.4f} ms (n=100, host clock); peak memory "
        f"{torch.cuda.max_memory_allocated()} B [{card}]")
    return med


def detector_profile(det, x, card, label, calls=5):
    """Where a detector call's device time goes: the ``det:*`` ranges of
    export/detector.py and ops/nms.py, the int8 QDQ hooks (``qdq``), and
    the conv kernels by name, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    det(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            det(x)
        wall_us = (time.perf_counter() - t0) * 1e6
    # the det:* / qdq ranges as the host saw them (each a sum of the device
    # time of the kernels launched inside it); the profiler also lists
    # their spans on the device timeline, which hold idle gaps: skipped
    ranges = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and (
                ev.name.startswith("det:") or ev.name == "qdq"):
            ranges[ev.name] = ranges.get(ev.name, 0.0) + ev.device_time_total
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not (e.key.startswith("det:") or e.key == "qdq")]
    busy = sum(e.self_device_time_total for e in kernels)
    if not busy:
        say(f"profile {label}: the profiler recorded no device time; "
            f"breakdown not measured")
        return {}
    convs = sum(e.self_device_time_total for e in kernels
                if CONV_KERNEL.search(e.key))
    launches = sum(e.count for e in kernels) / calls
    rows = {"device_busy_us": busy / calls, "host_us": wall_us / calls,
            "launches": launches, "convs_us": convs / calls,
            **{k: v / calls for k, v in sorted(ranges.items())}}
    rows["network_other_us"] = (rows.get("det:network", 0.0)
                                - rows["convs_us"] - rows.get("qdq", 0.0))
    say(f"profile {label} batch {len(x)}, {calls} calls: device busy "
        f"{busy / calls:.1f} us/call of {wall_us / calls:.1f} us/call host "
        f"clock ({100 * busy / wall_us:.1f}% busy), {launches:.0f} device "
        f"launches a call; NMS fixpoint steps "
        f"{det.stats.get('greedy_steps')} [{card}]")
    for name, us in rows.items():
        if name.endswith("_us") and name not in ("device_busy_us",
                                                 "host_us") or \
                name.startswith("det:") or name == "qdq":
            say(f"  {name:20s} {us:10.1f} us/call "
                f"{100 * us * calls / busy:5.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"  kernel {e.self_device_time_total / calls:9.1f} us/call "
            f"x{e.count // calls} {e.key[:80]}")
    return rows


def phase_detection(card):
    """Phase 6: both committed detector engines on the card (see the module
    docstring); returns one record per engine."""
    from rtdm_tpu_torch.eval.detection import (candidates, compare_detections,
                                               per_frame, summary)
    from rtdm_tpu_torch.export.detector import load_detector
    from rtdm_tpu_torch.ops.acff import ACFF_KERNEL, LAUNCHES
    from rtdm_tpu_torch.ops.nms import batched_nms
    from rtdm_tpu_torch.ops.yolo import decode_all
    with np.load(GOLDEN_DET) as g:
        golden = dict(g)
    frames = golden["frames_416"]
    records = {}
    for name in DETECTORS:
        directory = str(ENGINES / name)
        t0 = time.perf_counter()
        det = load_detector(directory)
        load_s = time.perf_counter() - t0
        b = det.batch_size
        x = np.resize(frames, (b,) + frames.shape[1:])
        _count_from_zero()
        got = det(x)
        acff = ACFF_KERNEL.launches + sum(LAUNCHES.values())
        steps = det.stats["greedy_steps"]
        if acff:
            raise AssertionError(f"{name}: {acff} ACFF launches in a "
                                 f"detector forward")
        spec = det.spec
        got = (*got, candidates(det.predictions(x), spec.conf_thres))
        cpu_det = load_detector(directory, device="cpu")
        cpu = (*cpu_det(x), candidates(cpu_det.predictions(x),
                                       spec.conf_thres))
        frames_of = [k % len(frames) for k in range(b)]
        want = (golden[f"det_{name}"][frames_of],
                golden[f"count_{name}"][frames_of],
                per_frame(golden[f"cand_{name}"], frames_of))
        reps = {}
        for who, ref in (("cpu_port", cpu), ("jax_golden", want)):
            reps[who] = compare_detections(*ref[:2], *got[:2],
                                           spec.conf_thres, spec.iou_thres,
                                           ref[2], got[2])
            say(f"detect {name} card vs {who}: {summary(reps[who])}")
            for row in reps[who]["edge_unmatched"]:
                say(f"  at a decision edge: {row}")
            if not reps[who]["ok"]:
                raise AssertionError(f"{name} card vs {who}: "
                                     f"{reps[who]['failures']}")
            unequal = b - reps[who]["count_equal_frames"]
            if name.startswith("yolov4-tiny") and unequal:
                raise AssertionError(f"{name} card vs {who}: counts differ "
                                     f"in {unequal} frames")
        # decode and NMS on the card against the CPU on identical inputs
        raw = det.raw_maps(torch.as_tensor(x, device="cuda"))
        with torch.inference_mode():
            pred = decode_all(raw, det.heads, x.shape[1:3])
            pred_cpu = decode_all([r.cpu() for r in raw], det.heads,
                                  x.shape[1:3])
            kw = dict(multi_label=spec.multi_label, method=spec.nms_method,
                      class_agnostic=spec.class_agnostic,
                      classes=spec.classes)
            nms_card = batched_nms(pred, spec.conf_thres, spec.iou_thres,
                                   spec.max_det, spec.top_k, **kw)
            nms_cpu = batched_nms(pred_cpu, spec.conf_thres, spec.iou_thres,
                                  spec.max_det, spec.top_k, **kw)
        decode_equal = torch.equal(pred.cpu(), pred_cpu)
        nms_equal = all(torch.equal(a.cpu(), c)
                        for a, c in zip(nms_card, nms_cpu))
        say(f"detect {name}: decode on the card bit-equal to the CPU on the "
            f"same raw maps: {decode_equal}; NMS on the same rows: "
            f"{nms_equal}; ACFF launches in a forward: {acff}; NMS fixpoint "
            f"steps: {steps}; load {load_s:.2f} s")
        if not (decode_equal and nms_equal):
            raise AssertionError(f"{name}: decode or NMS on the card differs "
                                 f"from the CPU on the same inputs")
        med = {1: detector_latency(load_detector(directory, batch_size=1),
                                   x[:1], card, name),
               b: detector_latency(det, x, card, name)}
        say(f"throughput {name} batch {b}: {b * 1e3 / med[b]:.1f} frames/s "
            f"(median) [{card}]")
        records[name] = {
            "batch": b, "acff_launches": acff, "greedy_steps": steps,
            "latency_median_ms": med, "frames_per_s": b * 1e3 / med[b],
            "vs": {k: {f: v[f] for f in ("bit_equal_frames",
                                         "count_equal_frames", "matched",
                                         "detections", "max_box_px",
                                         "max_conf_diff", "min_iou")}
                   for k, v in reps.items()},
            "profile": detector_profile(det, x, card, name)}
    return records


def phase_fault2():
    """Phase 3, ROADMAP fault 2: every shape of ``FAULT2_SHAPES`` in each
    mode against the plain version (``hold_to_plain``), with the launches
    ``acff_decomposed`` and the wide-C variant must make; then the wide-C
    variant timed at ``WIDE_SHAPES`` (batch 256) with its shared memory
    (against ``bf16_wide_smem_bytes``), registers and share of its bound.
    Returns (one row a checked shape, one record a timed wide shape)."""
    from collections import Counter

    from rtdm_tpu_torch.ops.acff import (acff_infer, acff_infer_plain,
                                         kernel_variant, o_splits,
                                         padded_channels, tile_plan)
    rng = np.random.default_rng(SEED + 2)
    rows = []
    for quant in ("fp32", "bf16", "int8", "int8_branch"):
        dtype = DTYPES[quant]
        for b, c, o, hw in FAULT2_SHAPES:
            args, ops, qs = kernel_inputs(rng, b, c, o, hw, hw, quant,
                                          operands=True)
            plan = tile_plan(b, hw, hw)
            expect = dict(Counter(
                kernel_variant(dtype, qs, padded_channels(c, dtype), w, plan)
                for _, _, w in o_splits(o)))
            label = f"fault 2 {quant} x=({b},{hw},{hw},{c}) O={o}"
            err, got, want = hold_to_plain(args, ops, qs, quant, label,
                                           expect)
            rows.append({"quant": quant, "x": [b, hw, hw, c], "o": o,
                         "launches": expect, "max_abs_err": err})
            say(f"{label}: launches {expect} max_abs_err={err:.3e}")
            del args, ops, got, want
    records = []
    for quant in ("bf16", "int8", "int8_branch"):
        variant = f"{quant}_wide"
        for c, o, hw in WIDE_SHAPES:
            args, ops, qs = kernel_inputs(rng, BATCH, c, o, hw, hw, quant,
                                          operands=True)
            label = f"wide {quant} x=({BATCH},{hw},{hw},{c}) O={o}"
            err, got, want = hold_to_plain(args, ops, qs, quant, label,
                                           {variant: 1})
            ms = graph_ms(lambda: acff_infer(*args, ops, act_scales=qs), 20)
            plain_ms = graph_ms(lambda: acff_infer_plain(
                *args, act_scales=qs), 5)
            bound_ms, bound_by, nbytes, n_ops = bound(BATCH, c, o, hw, hw,
                                                      "bf16")
            smem, per_sm, regs = footprint(variant, BATCH, c, o, hw, hw)
            records.append(dict(
                quant=variant, x=[BATCH, hw, hw, c], o=o, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms,
                bytes=nbytes, ops=n_ops, smem_bytes=smem,
                blocks_per_sm=per_sm, registers=regs))
            say(f"kernel {label} ({KERNEL_NAME[variant]}): max_abs_err="
                f"{err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
                f"{bound_ms:.4f} ({bound_by}, {100 * bound_ms / ms:.1f}% of "
                f"bound) smem={smem} B blocks/SM={per_sm} regs={regs} "
                f"library_ms=n/a")
            del args, ops, got, want
    return rows, records


def _quiet(fn, *args, **kwargs):
    """fn's result and what it printed."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _padded_rows(rows):
    counts = np.array([len(r) for r in rows], np.int32)
    out = np.zeros((len(rows), max(int(counts.max()), 1), 6), np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, counts


def _to_letterbox(rows, letterbox):
    """(n, m, 6) rows in original-image pixels -> letterbox pixels."""
    out = rows.copy()
    g, pw, ph = (letterbox[:, k][:, None] for k in range(3))
    for k, pad in ((0, pw), (1, ph), (2, pw), (3, ph)):
        out[:, :, k] = rows[:, :, k] * g + pad
    return out


def _kept(pre, post):
    """Per row of ``pre``, whether ``post`` (the vetoed rows) holds it."""
    return np.array([bool(len(post)) and bool(
        (np.abs(post - r).max(axis=1) == 0).any()) for r in pre], bool)


def _veto_differences(p_rows, p_keep, g_rows, g_keep, logits, label):
    """Veto decisions of one run unlike the golden's, per frame over the
    detector's rows (``p_rows``, ``g_rows``: (n, 6) on the letterboxed
    frame; ``*_keep``: kept by the veto), a row matched to the golden's of
    its class with corners within 3 px. Where both give the classifier the
    same crop box (``square_pad_boxes``), the golden's two top logits must
    lie within ``VETO_TIE`` of max |logit|; a row whose crop box moved is
    another input and is only counted. Returns (near ties, moved)."""
    from rtdm_tpu_torch.export.second_stage import square_pad_boxes
    top = np.abs(logits).max()
    ties = moved = 0
    for i in range(len(p_rows)):
        for j, row in enumerate(p_rows[i]):
            if not len(g_rows[i]):
                continue
            d = np.abs(g_rows[i][:, :4] - row[:4]).max(1)
            same = (d <= 3.0) & (g_rows[i][:, 5] == row[5])
            if not same.any():
                continue
            k = int(np.argmin(np.where(same, d, np.inf)))
            if g_keep[i][k] == p_keep[i][j]:
                continue
            boxes = square_pad_boxes(torch.from_numpy(
                np.stack([g_rows[i][k, :4], row[:4]])))
            if not torch.equal(boxes[0], boxes[1]):
                moved += 1
                continue
            two = np.sort(logits[i, k])[-2:]
            if not two[1] - two[0] <= VETO_TIE * top:
                raise AssertionError(
                    f"{label}: frame {i} row {j}: the veto decides otherwise "
                    f"than the golden on the same crop, whose top logits "
                    f"{two.tolist()} are not a near tie")
            ties += 1
    return ties, moved


def _mean_f1(res):
    """yolo_test's mean F1 of the classes present, at the operating point
    where its P and R were taken."""
    pc = res["per_class"]
    return float(pc["f1"][pc["classes"]].mean())


def _frame_ms(printed):
    """The per-frame milliseconds yolo_detect printed, in order."""
    return [float(m) for m in re.findall(r": \d+ detections \(([\d.]+) ms",
                                         printed)]


def phase_detect_cli(card, work):
    """Phase 7: the detection CLIs on the card (see the module
    docstring). Returns the records and, by path, the ACFF launches of the
    veto runs."""
    from rtdm_tpu_torch.cli.yolo_detect import main as yolo_detect
    from rtdm_tpu_torch.cli.yolo_test import evaluate
    from rtdm_tpu_torch.data.example_set import (write_engine_as_cfg,
                                                 write_example_set)
    from rtdm_tpu_torch.eval.detection import (candidates, compare_detections,
                                               per_frame, summary)
    from rtdm_tpu_torch.export.detector import load_detector
    from rtdm_tpu_torch.ops.acff import ACFF_KERNEL, LAUNCHES
    with np.load(GOLDEN_CLI) as g:
        gold = dict(g)
    with np.load(GOLDEN_DET) as g:
        frames = g["frames_416"]
        gold_cand = {e: g[f"cand_{e}"] for e in DETECTORS}
        gold_det = {e: g[f"det_{e}"] for e in DETECTORS}
    lb = gold["letterbox"]
    examples = ROOT / "docs" / "examples"
    records, launches = {}, {}

    def detect(engine, device, out, classify=False, source=examples):
        argv = ["--engine", str(ENGINES / engine), "--source", str(source),
                "--output", str(work / out), "--save-txt", "--txt-format",
                "map", "--nosave", "--device", device]
        if classify:
            argv += ["--classify", VETO[0], "--classifier-weights",
                     str(VETO[1])]
        res, printed = _quiet(yolo_detect, argv)
        return [np.asarray(d, np.float32) for _, d in res], printed

    def engine_rows(engine, device):
        """The detector's rows of each letterboxed golden frame at batch 1
        (the rows yolo_detect scales back), and its NMS candidates."""
        det = load_detector(str(ENGINES / engine), device=device,
                            batch_size=1)
        rows = []
        for i in range(len(frames)):
            d, c = det(frames[i:i + 1])
            rows.append(d[0, :int(c[0])])
        return rows, per_frame(np.concatenate([
            np.c_[np.full(len(r), i), r] for i, r in enumerate(
                candidates(det.predictions(frames[i:i + 1]),
                           det.spec.conf_thres)[0]
                for i in range(len(frames)))]), range(len(frames)))

    def counted(path, fn, *args, **kwargs):
        _count_from_zero()
        out = fn(*args, **kwargs)
        launches[path] = dict(LAUNCHES)
        return out

    for engine in DETECTORS:
        rec = {}
        card_rows, _ = counted(f"{engine}/yolo_detect", detect, engine,
                               "cuda", f"{engine}_card")
        if sum(launches[f"{engine}/yolo_detect"].values()) or \
                ACFF_KERNEL.launches:
            raise AssertionError(f"{engine}: ACFF launches without the veto")
        cpu_rows, _ = detect(engine, "cpu", f"{engine}_cpu")
        got = _padded_rows(card_rows)
        card_det, card_cand = engine_rows(engine, "cuda")
        cpu_det, cpu_cand = engine_rows(engine, "cpu")
        refs = {"cpu_port": (*_padded_rows(cpu_rows), cpu_cand),
                "jax_golden": (gold[f"rows_{engine}"],
                               gold[f"count_{engine}"],
                               per_frame(gold_cand[engine],
                                         range(len(frames))))}
        for who, (rows, count, cand) in refs.items():
            rep = compare_detections(_to_letterbox(rows, lb), count,
                                     _to_letterbox(got[0], lb), got[1],
                                     0.25, 0.45, cand, card_cand)
            say(f"yolo_detect {engine} card vs {who} (letterbox px): "
                f"{summary(rep)}")
            if not rep["ok"]:
                raise AssertionError(f"yolo_detect {engine} card vs {who}: "
                                     f"{rep['failures']}")
            if engine.startswith("yolov4-tiny") and \
                    rep["count_equal_frames"] != len(frames):
                raise AssertionError(f"yolo_detect {engine} card vs {who}: "
                                     f"counts differ")
            rec[f"vs_{who}"] = {k: rep[k] for k in (
                "bit_equal_frames", "count_equal_frames", "matched",
                "detections", "max_box_px", "max_conf_diff")}
        # the veto: 4 bf16 ACFF launches (Squeeze_ErNET's blocks) for every
        # frame with a detection, no other kernel
        path = f"{engine}/yolo_detect --classify"
        veto_rows, _ = counted(path, detect, engine, "cuda",
                               f"{engine}_veto", classify=True)
        with_dets = sum(1 for r in card_rows if len(r))
        want = {k: 4 * with_dets if k == "bf16" else 0 for k in LAUNCHES}
        if launches[path] != want or ACFF_KERNEL.launches != 4 * with_dets:
            raise AssertionError(f"{path}: ACFF launches {launches[path]}, "
                                 f"expected {want}")
        cpu_veto, _ = detect(engine, "cpu", f"{engine}_veto_cpu",
                             classify=True)
        counts = gold[f"count_{engine}"]
        g_rows = [gold_det[engine][i, :int(counts[i])]
                  for i in range(len(frames))]
        g_keep = [_kept(gold[f"rows_{engine}"][i, :int(counts[i])],
                        gold[f"veto_rows_{engine}"][i, :int(
                            gold[f"veto_count_{engine}"][i])])
                  for i in range(len(frames))]
        logits = gold[f"veto_logits_{engine}"]
        diff_gold = _veto_differences(
            card_det, [_kept(a, b) for a, b in zip(card_rows, veto_rows)],
            g_rows, g_keep, logits, f"{path} vs golden")
        diff_cpu = _veto_differences(
            cpu_det, [_kept(a, b) for a, b in zip(cpu_rows, cpu_veto)],
            g_rows, g_keep, logits, f"{path} CPU port vs golden")
        kept = [len(r) for r in veto_rows]
        say(f"{path}: kept {sum(kept)} of {sum(len(r) for r in card_rows)} "
            f"rows (per frame {kept}; CPU port "
            f"{[len(r) for r in cpu_veto]}; golden "
            f"{gold[f'veto_count_{engine}'].tolist()}); decisions unlike "
            f"the golden's (at a near tie of its logits, on a moved crop): "
            f"card {diff_gold}, CPU port {diff_cpu}; bf16 ACFF launches "
            f"{launches[path]['bf16']} "
            f"({with_dets} frames with detections)")
        rec.update(veto_kept=kept, veto_near_tie_card=diff_gold,
                   veto_near_tie_cpu=diff_cpu,
                   veto_launches=launches[path]["bf16"])
        records[engine] = rec

    # yolo_test on the labelled example set, card against the CPU port
    data = write_example_set(work / "set")
    runs = [(e, q, False) for e in DETECTORS for q in ("bf16", "int8")]
    runs.append(("yolov5s-mini_int8", "bf16", True))
    for engine, quant, rect in runs:
        cfg, weights = write_engine_as_cfg(ENGINES / engine, work / "models")
        kw = dict(quant=quant, rect=rect, num_workers=4,
                  full_map_range=cfg.endswith(".yaml"))
        label = f"yolo_test {engine} {quant}" + (" --rect" if rect else "")
        res, printed = _quiet(evaluate, cfg, data, weights, 416, CLI_BATCH,
                              device="cuda", **kw)
        cpu, cpu_printed = _quiet(evaluate, cfg, data, weights, 416,
                                  CLI_BATCH, device="cpu", **kw)
        for line in printed.splitlines():
            say(f"  {label} [card]: {line}")
        got, ref = (np.array([r["mp"], r["mr"], r["map50"], _mean_f1(r)])
                    for r in (res, cpu))
        held = [2, 3] if cfg.endswith(".yaml") else [0, 1, 2]
        tol = np.full(4, METRIC_TOL)
        if cfg.endswith(".yaml") and quant == "int8":
            tol[3] = V5_INT8_F1_TOL
        if not (np.abs(got - ref)[held] <= tol[held]).all():
            raise AssertionError(f"{label}: P/R/mAP@0.5/F1 {got} vs CPU "
                                 f"port {ref} (limits {tol[held]} on "
                                 f"{held})")
        if rect:
            buckets = [ln for ln in printed.splitlines()
                       if ln.startswith("rect buckets")]
            if not buckets or buckets != [
                    ln for ln in cpu_printed.splitlines()
                    if ln.startswith("rect buckets")]:
                raise AssertionError(f"{label}: bucket shapes differ from "
                                     f"the CPU's")
        wall = float(re.search(r"wall ([\d.]+) ms/img", printed).group(1))
        infer = float(re.search(r"([\d.]+) ms/img infer\+NMS",
                                printed).group(1))
        say(f"{label}: P/R/mAP@0.5/mean F1 card {got.round(4).tolist()} "
            f"CPU port {ref.round(4).tolist()} (limits {tol[held].tolist()} "
            f"on {'mAP@0.5, F1' if len(held) == 2 else 'P, R, mAP@0.5'}); "
            f"{1e3 / wall:.1f} images/s with loading, infer+NMS "
            f"{infer} ms/img [{card}]")
        records[label] = {"card": got.tolist(), "cpu_port": ref.tolist(),
                          "images_per_s": 1e3 / wall, "infer_nms_ms": infer,
                          "wall_ms": wall}

    # yolo_detect ms/frame at batch 1: the examples repeated to
    # TIMED_FRAMES, the first WARM_FRAMES left out
    timed = work / "timed"
    timed.mkdir(exist_ok=True)
    names = sorted(examples.glob("*.jpg"))
    for k in range(TIMED_FRAMES):
        src = names[k % len(names)]
        shutil.copy(src, timed / f"{k:03d}_{src.name}")
    for engine in DETECTORS:
        for classify in (False, True):
            _, printed = detect(engine, "cuda", f"{engine}_timed",
                                classify=classify, source=timed)
            ms = _frame_ms(printed)[WARM_FRAMES:]
            med, p90 = _percentiles(ms)
            label = f"yolo_detect {engine}" + (" --classify" if classify
                                               else "")
            say(f"{label}: {med} ms/frame median, {p90} p90 at batch 1 "
                f"(n={len(ms)}, host clock) [{card}]")
            records[label + " ms"] = {"median": med, "p90": p90,
                                      "frames": len(ms)}
    return records, launches


def phase_serve(card, work, launches):
    """Phase 8a: rtdm-serve with an fp32 classifier and an int8 detector
    side by side, both driven at once; each reply held to the lone direct
    call; the TF32 control; run_direct for each engine."""
    import threading
    from rtdm_tpu_torch.cli.serve import (_ClassifyService, _DetectService,
                                          classify_frame, detect_frame,
                                          detections_to_json, make_server)
    from rtdm_tpu_torch.cli.serve_loadtest import run_direct, run_load
    from rtdm_tpu_torch.core.precision import tf32
    from rtdm_tpu_torch.data.aider import normalize_batch
    from rtdm_tpu_torch.export.engine import Engine
    from rtdm_tpu_torch.models.ernet import CLASS_NAMES
    examples = sorted((ROOT / "docs" / "examples").glob("*.jpg"))
    bodies = [p.read_bytes() for p in examples]   # the native decode
    loaded = Engine.load(str(ENGINES / "squeeze-ernet_bf16"))
    fp32_dir = str(work / "squeeze-ernet_fp32")
    Engine(dataclasses.replace(loaded.spec, quant="fp32"),
           loaded.variables).save(fp32_dir)
    classify = _ClassifyService(fp32_dir, 2.0, 2)
    detect = _DetectService(str(ENGINES / DETECTORS[0]), 2.0, 2)
    server = make_server(0, classify, detect, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    replies = {"/v1/classify": [], "/v1/detect": []}
    load = {}

    def drive(endpoint):
        load[endpoint] = run_load(url, endpoint, SERVE_CLIENTS,
                                  SERVE_REQUESTS, timeout=120.0,
                                  bodies=bodies, responses=replies[endpoint])

    try:
        _count_from_zero()
        loads = [threading.Thread(target=drive, args=(e,)) for e in replies]
        for t in loads:
            t.start()
        for t in loads:
            t.join(600)
        if any(t.is_alive() for t in loads):
            raise AssertionError("serve: a load thread did not finish")
        stats = {"classify": classify.batcher.stats().as_dict(),
                 "detect": detect.batcher.stats().as_dict()}
        path = (f"rtdm-serve classify fp32 ({stats['classify']['batches']} "
                f"batches beside the int8 detector)")
        _read_launches(path, launches,
                       _only("fp32", 4 * stats["classify"]["batches"]))
    finally:
        server.shutdown()
        server.server_close()
        classify.batcher.close()
        detect.batcher.close()
        thread.join(30)
    n = SERVE_CLIENTS * SERVE_REQUESTS
    for endpoint, res in load.items():
        if res["errors"] or res["requests"] != n or \
                len(replies[endpoint]) != n:
            raise AssertionError(f"serve {endpoint}: {res}")
    # each reply against the lone direct call, no other thread running
    frames = [classify_frame(b, classify.size) for b in bodies]
    direct = [classify.engine(f[None])[0] for f in frames]
    worst, bit_equal = 0.0, 0
    for k, reply in replies["/v1/classify"]:
        p = np.array(list(reply["probs"].values()), np.float32)
        err = float(np.abs(p - direct[k]).max())
        bit_equal += int(np.array_equal(p, direct[k]))
        worst = max(worst, err / float(np.abs(direct[k]).max()))
        if err > SERVE_PROB_TOL * np.abs(direct[k]).max() or \
                reply["label"] != CLASS_NAMES[int(direct[k].argmax())]:
            raise AssertionError(f"serve classify: body {k} reply differs "
                                 f"from the lone fp32 call by {err}")
    say(f"serve classify fp32 beside int8 detect: {bit_equal}/{n} replies "
        f"bit-equal to the lone direct call, max |dprob| {worst:.3e} of "
        f"max|prob| (limit {SERVE_PROB_TOL})")
    # the control: the same model with TF32 on misses the fp32 gate
    eng = classify.engine
    x = torch.as_tensor(np.stack(frames), device=eng.device)
    with torch.inference_mode():
        xn = normalize_batch(x, eng._mean, eng._std)
        with tf32(False):
            ref = eng.model(xn, apply_softmax=False).float().cpu().numpy()
        with tf32(True):
            ctl = eng.model(xn, apply_softmax=False).float().cpu().numpy()
    ctl_err = float(np.abs(ctl - ref).max() / np.abs(ref).max())
    say(f"serve control: the fp32 model under tf32(True): max |dlogit| "
        f"{ctl_err:.3e} of max|logit| (fp32 gate {LOGIT_REL_TOL['fp32']}: "
        f"must miss it)")
    if ctl_err <= LOGIT_REL_TOL["fp32"]:
        raise AssertionError("serve control: TF32 did not move the fp32 "
                             "logits past the gate; the check cannot fail")
    det_equal = 0
    for k, reply in replies["/v1/detect"]:
        boxed, gain, pads, orig_hw = detect_frame(bodies[k], detect.size)
        d, c = detect.det(boxed[None])
        want = detections_to_json(d[0], int(c[0]), gain, pads, orig_hw,
                                  detect.names)
        if reply != want:
            raise AssertionError(f"serve detect: body {k} reply differs "
                                 f"from the direct Detector call")
        det_equal += 1
    say(f"serve detect int8 beside fp32 classify: {det_equal}/{n} replies "
        f"equal to the direct Detector call + detections_to_json")
    record = {"load": {e.split("/")[-1]: r for e, r in load.items()},
              "stats": stats, "classify_bit_equal": bit_equal,
              "classify_max_rel": worst, "tf32_control_rel": ctl_err}
    for e, r in load.items():
        s = stats[e.split("/")[-1]]
        say(f"serve {e} under load ({SERVE_CLIENTS} clients x "
            f"{SERVE_REQUESTS}, both endpoints at once): {r['rps']} rps, "
            f"client p50 {r['p50_ms']} ms p99 {r['p99_ms']} ms; batcher "
            f"mean_batch {s['mean_batch']:.2f} of {s['batches']} batches, "
            f"rows_padded {s['rows_padded']}, p50 {s['p50_ms']:.2f} ms p99 "
            f"{s['p99_ms']:.2f} ms [{card}]")
    # handler-direct capacity of each engine, alone
    direct_runs = {"classify fp32": {"engine_dir": fp32_dir},
                   "classify bf16": {"engine_dir": str(
                       ENGINES / "squeeze-ernet_bf16")},
                   "classify int8": {"engine_dir": str(
                       ENGINES / "squeeze-ernet_int8")},
                   "detect int8": {"detector_dir": str(
                       ENGINES / DETECTORS[0])}}
    record["direct"] = {}
    for label, kw in direct_runs.items():
        _count_from_zero()
        res = run_direct(clients=SERVE_CLIENTS,
                         requests_per_client=SERVE_REQUESTS, **kw)
        got = _read_launches(f"serve_loadtest --direct {label}", launches)
        kind = label.split()[1] if label.startswith("classify") else None
        if (kind and (got[kind] % 4 or not got[kind]
                      or sum(got.values()) != got[kind])) or \
                (not kind and sum(got.values())) or \
                res["handler"]["errors"] or res["core"]["errors"]:
            raise AssertionError(f"run_direct {label}: {res}, launches "
                                 f"{got}")
        record["direct"][label] = res
        say(f"run_direct {label}: decode {res['decode_ms']} ms; handler "
            f"{res['handler']['rps']} rps (p99 {res['handler']['p99_ms']} "
            f"ms), core {res['core']['rps']} rps (p99 "
            f"{res['core']['p99_ms']} ms), mean batch "
            f"{res['batcher_mean_batch']:.2f}; ACFF launches {got} [{card}]")
    return record


def phase_realtime(card, launches):
    """Phase 8b: realtime_inference on the bf16 engine over the examples."""
    import cv2
    from rtdm_tpu_torch.cli.aider_predict import load_image_rgb
    from rtdm_tpu_torch.cli.realtime_inference import main as realtime
    from rtdm_tpu_torch.export.engine import Engine
    examples = sorted((ROOT / "docs" / "examples").glob("*.jpg"))
    engine_dir = str(ENGINES / "squeeze-ernet_bf16")
    resized = np.stack([cv2.resize(load_image_rgb(str(p)), (140, 140),
                                   interpolation=cv2.INTER_LINEAR)
                        for p in examples])
    direct = Engine.load(engine_dir)(resized)
    want = [(int(p.argmax()), float(p.max())) for p in direct]
    records = {}
    want = [want[k % len(want)] for k in range(REALTIME_FRAMES)]
    for b in REALTIME_BATCHES:
        _count_from_zero()
        report, _ = _quiet(realtime, ["--source", str(examples[0].parent),
                                      "--video-looping", "--max-frames",
                                      str(REALTIME_FRAMES), "--engine",
                                      engine_dir, "--batch", str(b),
                                      "--power"])
        batches = -(-REALTIME_FRAMES // b)
        _read_launches(f"realtime_inference bf16 --batch {b} "
                       f"({REALTIME_FRAMES} frames)", launches,
                       _only("bf16", 4 * batches))
        if report["frames"] != REALTIME_FRAMES or \
                report["predictions"] != want:
            raise AssertionError(f"realtime --batch {b}: labels differ from "
                                 f"the direct Engine calls")
        records[b] = {k: report[k] for k in (
            "fps_avg", "fps_min", "fps_max", "ms_per_batch", "mj_per_frame",
            "chip_watts")}
        say(f"realtime_inference bf16 --batch {b}: labels equal the direct "
            f"Engine calls; FPS avg {report['fps_avg']:.1f} min "
            f"{report['fps_min']:.1f} max {report['fps_max']:.1f}, "
            f"{report['ms_per_batch']:.3f} ms/batch, "
            f"{report['mj_per_frame']:.3f} mJ/frame modelled at "
            f"{report['chip_watts']} W; bf16 ACFF launches "
            f"{4 * batches} [{card}]")
    return records


def phase_cascade(card, work, launches):
    """Phase 8c: the cascade at 416 in bf16 and fp32 on the golden frames,
    against the port on the CPU and the JAX golden, and timed."""
    from rtdm_tpu_torch.cli.cascade_stream import build_cascade
    from rtdm_tpu_torch.eval.detection import (candidates, compare_detections,
                                               per_frame, summary)
    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.models.io import tree_digest
    with np.load(GOLDEN_CASCADE) as g:
        gold = dict(g)
    with np.load(GOLDEN_DET) as g:
        frames = g["frames_416"]
    cfg = work / "yolov4-tiny-mini.cfg"
    cfg.write_text((ENGINES / DETECTORS[0] / "model.txt").read_text())
    digest = tree_digest(load_detection_model(str(cfg), None, 416)[1])
    if digest != str(gold["det_weights_digest"]):
        raise AssertionError("cascade: the seeded detector init differs from "
                             "the golden's weights")
    conf, iou = float(gold["conf_thres"]), float(gold["iou_thres"])
    records = {}

    def run(cascade, count_path=None):
        """The cascade on each frame, its launches counted from 0 for each
        and summed under ``count_path`` (4 of its precision a frame)."""
        out, cands, total = [], [], _only(quant, 0)
        for i in range(len(frames)):
            if count_path:
                _count_from_zero()
            probs, det, count = cascade(frames[i:i + 1])
            out.append((probs.cpu().numpy(), det.cpu().numpy(),
                        count.cpu().numpy()))
            if count_path:
                got = _read_launches(f"{count_path} frame {i}", {},
                                     _only(quant, 4))
                total = {k: total[k] + got[k] for k in total}
            with torch.inference_mode():
                pred = cascade.detector.decoded(
                    cascade.detector._upload(frames[i:i + 1])[0])
            cands.append(candidates(pred.float().cpu().numpy(), conf)[0])
        if count_path:
            launches[count_path] = total
        return [np.concatenate([o[k] for o in out]) for k in range(3)] + \
            [cands]

    for quant in ("bf16", "fp32"):
        args = (str(cfg), None, VETO[0], str(VETO[1]), 416, conf, iou, quant)
        on_card = build_cascade(*args)
        got = run(on_card, f"cascade_stream {quant} ({len(frames)} frames "
                           f"at 416)")
        ref = {"cpu_port": run(build_cascade(*args, device="cpu")),
               "jax_golden": [gold[f"probs_{quant}"], gold[f"det_{quant}"],
                              gold[f"count_{quant}"],
                              per_frame(gold[f"cand_{quant}"],
                                        range(len(frames)))]}
        rec = {}
        for who, want in ref.items():
            err = float(np.abs(got[0] - want[0]).max()
                        / np.abs(want[0]).max())
            rep = compare_detections(want[1], want[2], got[1], got[2], conf,
                                     iou, want[3], got[3],
                                     box_rel=CASCADE_BOX_REL[quant])
            say(f"cascade {quant} card vs {who}: probs max |d| {err:.3e} of "
                f"max|prob| (limit {CASCADE_REL_TOL[quant]}), argmax equal "
                f"{np.array_equal(got[0].argmax(1), want[0].argmax(1))}; "
                f"detections {summary(rep)}")
            if not (err <= CASCADE_REL_TOL[quant] and rep["ok"] and
                    np.array_equal(got[0].argmax(1), want[0].argmax(1))):
                raise AssertionError(f"cascade {quant} card vs {who}: "
                                     f"{err}, {rep['failures']}")
            rec[who] = {"probs_rel": err, **{f: rep[f] for f in (
                "bit_equal_frames", "count_equal_frames", "matched",
                "detections", "max_box_px", "max_conf_diff")}}
        ms = []
        for k in range(CASCADE_WARM + CASCADE_TIMED):
            t0 = time.perf_counter()
            probs, det, count = on_card(frames[k % len(frames)][None])
            probs.cpu(), det.cpu(), count.cpu()
            ms.append(1e3 * (time.perf_counter() - t0))
        med, p90 = _percentiles(ms[CASCADE_WARM:])
        rec.update(ms_median=med, ms_p90=p90, frames=CASCADE_TIMED)
        records[quant] = rec
        say(f"cascade_stream {quant} at 416, batch 1: {med:.3f} ms/frame "
            f"median, {p90:.3f} p90 (n={CASCADE_TIMED}, host clock); "
            f"{quant} ACFF launches 4 a frame [{card}]")
    return records


def phase_autoshape(launches):
    """Phase 8d: AutoShape over both detectors on the examples, as paths
    and as arrays, equal to the Detector plus the un-letterbox."""
    from rtdm_tpu_torch.cli.aider_predict import load_image_rgb
    from rtdm_tpu_torch.data.odder import letterbox_image
    from rtdm_tpu_torch.export.autoshape import AutoShape
    paths = [str(p) for p in sorted((ROOT / "docs" / "examples")
                                    .glob("*.jpg"))]
    arrays = [load_image_rgb(p) for p in paths]
    records = {}
    for name in DETECTORS:
        auto = AutoShape(str(ENGINES / name))
        _count_from_zero()
        results = [auto(paths), auto(arrays)]
        _read_launches(f"AutoShape {name}", launches, _only("bf16", 0))
        det, size = auto.detector, auto.detector.spec.img_size
        boxed = [letterbox_image(a, size) for a in arrays]
        want = []
        for start in range(0, len(boxed), det.batch_size):
            chunk = boxed[start:start + det.batch_size]
            d, c = det(np.stack([b[0] for b in chunk]))
            for j, (_, gain, (pw, ph)) in enumerate(chunk):
                h, w = arrays[start + j].shape[:2]
                rows = np.array(d[j][:int(c[j])], np.float32)
                if rows.size:
                    rows[:, [0, 2]] = ((rows[:, [0, 2]] - pw) / gain
                                       ).clip(0, w)
                    rows[:, [1, 3]] = ((rows[:, [1, 3]] - ph) / gain
                                       ).clip(0, h)
                want.append(rows)
        for res in results:
            if len(res) != len(paths) or not all(
                    np.array_equal(g, w) for g, w in zip(res.xyxy, want)):
                raise AssertionError(f"AutoShape {name}: results differ from "
                                     f"the Detector + un-letterbox")
        records[name] = sum(len(w) for w in want)
        say(f"AutoShape {name}: paths and arrays equal the Detector + "
            f"un-letterbox on {len(paths)} examples ({records[name]} "
            f"detections); no ACFF launch")
    return records


def phase_serving(card, work):
    """Phase 8: streaming, cascade and serving, from torch's TF32 defaults
    (cuDNN TF32 on), so that what is tested is each path's own setting.
    Returns the records and, by path, the ACFF launches."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    t0 = time.perf_counter()
    try:
        records = {"serve": phase_serve(card, work, launches),
                   "realtime": phase_realtime(card, launches),
                   "cascade": phase_cascade(card, work, launches),
                   "autoshape": phase_autoshape(launches)}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    records["seconds"] = time.perf_counter() - t0
    say(f"phase 8: {records['seconds']:.1f} s")
    return records, launches


# --- phase 9: training on the card ---------------------------------------

GOLDEN_TRAIN = GOLDEN.with_name("train.npz")
# case: (loss, grad_norm, params of the largest |param|, stats per leaf),
# the CPU port's gates against the golden (tests/test_torch_trainer.py),
# held on the card too
TRAIN_GATES = {"a": (1e-5, 3e-5, 2e-5, 1e-4), "b": (2e-4, 3e-3, 5e-3, 2e-3),
               "c": (3e-3, 2e-2, 1e-2, 1e-2)}
AIDER_SPLITS = {"train": 320, "val": 40, "test": 40}
AIDER_SIDE = 160
TRAIN_TIMED = 10
TRAIN_WARM = 3
# the train step's kernels by kind, by name (the first pattern that
# matches): cuDNN's grouped (depthwise) convs, its other convs (the 1x1
# fuse and head, the stem), its layout transforms, dtype casts and copies,
# reductions (BatchNorm's statistics and their gradients, the loss), the
# optimizer, the pools
TRAIN_KERNEL_KINDS = (
    ("depthwise conv (fwd, dgrad, wgrad)", r"grouped|c1_k1|depthwise"),
    ("cuDNN layout transforms", r"tensorTransform|nchwTo|nhwcTo"),
    ("other convs (1x1 fuse, head, stem)",
     r"xmma|implicit|gemm|conv|cudnn|sm90_|sm80_"),
    ("casts and copies", r"copy"),
    ("reductions (BN statistics and grads, loss)", r"reduce_kernel"),
    ("optimizer", r"multi_tensor|adam|Adam"),
    ("pools", r"pool"),
    ("elementwise (BN affine, LeakyReLU, mixing, clip, grad sums)", r""))
HUES = ((200, 30, 30), (30, 200, 30), (30, 30, 200), (200, 200, 30),
        (30, 200, 200))


def _train_golden():
    with np.load(GOLDEN_TRAIN) as g:
        golden = dict(g)
    golden["spec"] = json.loads(str(golden["spec"]))
    return golden


def golden_train_case(golden, case, device, decay_all=False, mesh=None):
    """The port's train step on ``device`` in one case of the train golden
    (three steps from its init on its batch): per-step metrics and the
    final variables, flat in the JAX layout. ``mesh``: the data-parallel
    step over it (every rank handed the whole batch)."""
    from rtdm_tpu_torch.core.precision import policy_from_name
    from rtdm_tpu_torch.data.aider import normalize_batch
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.models.io import (flatten_tree,
                                          torch_state_dict_from_variables,
                                          unflatten_tree,
                                          variables_from_torch_state_dict)
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import make_optimizer, make_schedule
    from rtdm_tpu_torch.train.trainer import (create_train_state,
                                              make_train_step)
    sp = golden["spec"]
    precision, opt, lr = sp["cases"][case]
    model = create_model(sp["model"], device=device,
                         dropout_rate=sp["dropout"])
    model.load_state_dict(torch_state_dict_from_variables(unflatten_tree(
        {k[5:]: v for k, v in golden.items() if k.startswith("init/")})))
    tx = make_optimizer(opt, make_schedule("onecycle", lr, sp["total_steps"],
                                           sp["warmup_ratio"]),
                        sp["weight_decay"], grad_clip=sp["grad_clip"],
                        decay_kernels_only=not decay_all)
    step = make_train_step(tx, make_classification_loss(
        sp["loss"], label_smoothing=sp["label_smoothing"]),
        policy_from_name(precision), sp["grad_accum_steps"], mesh=mesh)
    state = create_train_state(model, tx)
    x = normalize_batch(torch.from_numpy(golden["images"]).to(device))
    y = torch.from_numpy(golden["labels"]).long().to(device)
    metrics = {"loss": [], "accuracy": [], "grad_norm": []}
    for _ in range(sp["steps"]):
        state, m = step(state, x, y, 0)
        for k in metrics:
            metrics[k].append(float(m[k]))
    final = flatten_tree(variables_from_torch_state_dict(
        state.model.state_dict()))
    return {k: np.array(v) for k, v in metrics.items()}, final


def train_gaps(ref, metrics, final):
    """(loss, grad_norm, params, stats) gaps of a run to ``ref`` =
    (metrics, final): relative per step, params over the largest |param|,
    stats per leaf."""
    ref_m, ref_f = ref
    rel = [np.abs(metrics[k] - ref_m[k]).max() / np.abs(ref_m[k]).max()
           for k in ("loss", "grad_norm")]
    params = [k for k in ref_f if k.startswith("params/")]
    scale = max(np.abs(ref_f[k]).max() for k in params)
    p_gap = max(np.abs(final[k] - ref_f[k]).max() for k in params) / scale
    s_gap = max(np.abs(final[k] - ref_f[k]).max() / np.abs(ref_f[k]).max()
                for k in ref_f if k.startswith("batch_stats/"))
    return (*rel, p_gap, s_gap)


def phase_train_golden(card):
    """Phase 9a: the train golden's three cases on the card against the
    golden (TRAIN_GATES) and the port on the CPU (the same gates),
    and the control (weight decay on BatchNorm's scale too) that must
    miss case a's gate."""
    golden = _train_golden()
    records = {}
    for case in sorted(golden["spec"]["cases"]):
        ref = ({k: golden[f"{case}/{k}"] for k in ("loss", "accuracy",
                                                   "grad_norm")},
               {k[len(case) + 7:]: v for k, v in golden.items()
                if k.startswith(f"{case}/final/")})
        card_run = golden_train_case(golden, case, "cuda")
        cpu_run = golden_train_case(golden, case, "cpu")
        to_golden = train_gaps(ref, *card_run)
        to_cpu = train_gaps(cpu_run, *card_run)
        gate = TRAIN_GATES[case]
        records[case] = {"card_vs_golden": to_golden,
                         "card_vs_cpu_port": to_cpu,
                         "cpu_port_vs_golden": train_gaps(ref, *cpu_run),
                         "gate": gate, "loss": card_run[0]["loss"].tolist()}
        say(f"train golden case {case} {golden['spec']['cases'][case]}: "
            f"card vs golden (loss, grad_norm, params, stats) "
            f"{['%.3e' % v for v in to_golden]}; vs the CPU port "
            f"{['%.3e' % v for v in to_cpu]}; gate {gate}")
        if not all(g <= t for g, t in zip(to_golden + to_cpu, gate * 2)):
            raise AssertionError(f"train golden case {case}: card gaps "
                                 f"{to_golden} / {to_cpu} over {gate}")
    ctl = train_gaps(({k: golden[f"a/{k}"] for k in ("loss", "grad_norm")},
                      {k[8:]: v for k, v in golden.items()
                       if k.startswith("a/final/")}),
                     *golden_train_case(golden, "a", "cuda", decay_all=True))
    records["control_decay_all"] = ctl
    say(f"train golden control (decay on every parameter), case a: "
        f"{['%.3e' % v for v in ctl]}")
    if all(g <= t for g, t in zip(ctl, TRAIN_GATES["a"])):
        raise AssertionError("the decay-all control met case a's gate")
    return records


def phase_train_pool_check():
    """Phase 9a': the head's AvgPool2d(5, 1, 1) backward on the card
    against float64 on the CPU: the port's ``avg_pool2d`` (NCHW on CUDA)
    must be within 1e-6; torch's channels_last pool, which the port steps
    around, is printed beside it."""
    import torch.nn.functional as F

    from rtdm_tpu_torch.ops.convpool import avg_pool2d
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(8, 4, 4, 5, generator=gen, dtype=torch.float64)
    go = torch.randn(8, 2, 2, 5, generator=gen, dtype=torch.float64)

    def grad(fn, device, dtype):
        xx = x.to(device, dtype).clone().requires_grad_()
        fn(xx).backward(go.to(device, dtype))
        return xx.grad.double().cpu()

    def channels_last(t):
        return F.avg_pool2d(t.permute(0, 3, 1, 2), 5, 1, 1,
                            count_include_pad=True).permute(0, 2, 3, 1)

    pool = lambda t: avg_pool2d(t, 5, 1, 1)       # noqa: E731
    want = grad(pool, "cpu", torch.float64)
    errs = {name: float((grad(fn, "cuda", torch.float32) - want).abs().max()
                        / want.abs().max())
            for name, fn in (("port", pool), ("channels_last", channels_last))}
    say(f"head pool backward on the card vs float64: the port's "
        f"{errs['port']:.3e}, torch's channels_last pool "
        f"{errs['channels_last']:.3e} of max |grad|")
    if errs["port"] > 1e-6:
        raise AssertionError(f"avg_pool2d backward on the card: {errs}")
    return errs


def write_aider_set(root: Path, seed: int = SEED) -> Path:
    """An AIDER-style directory of hue-separable images (one hue a class,
    noise of sd 25) with train/val/test CSVs of AIDER_SPLITS rows."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    i = 0
    for split, n in AIDER_SPLITS.items():
        rows = []
        for _ in range(n):
            label = i % len(HUES)
            arr = np.clip(np.array(HUES[label], np.float32)
                          + rng.normal(0, 25, (AIDER_SIDE, AIDER_SIDE, 3)),
                          0, 255).astype(np.uint8)
            name = f"img_{i}.png"
            Image.fromarray(arr).save(root / name)
            rows.append(f"{name},{label}\n")
            i += 1
        (root / f"{split}.csv").write_text("".join(rows))
    return root


def phase_train_model(card, work, launches):
    """Phase 9b: ``train_model`` on the card, fp32 (batch 32, doubled to 64,
    3 epochs, no augmentation: the loss falls, val_acc >= 0.4) and bf16
    (the defaults: albumentations-style augmentations, mixup and cutmix,
    1 epoch: finite losses). The ACFF launches are counted from 0 around
    each run: 4 of the policy's kernel a validation or test batch, none in
    a train step. Returns the records and the fp32 run's config."""
    from rtdm_tpu_torch.cli.aider_train import train_model
    from rtdm_tpu_torch.core.config import TrainingConfig
    data = write_aider_set(work / "aider")
    splits = {s: str(data / f"{s}.csv") for s in AIDER_SPLITS}
    runs = {"fp32": dict(batch_size=32, epochs=3, augment=False),
            "bf16": dict(epochs=1)}
    records, configs = {}, {}
    for precision, kw in runs.items():
        config = TrainingConfig(
            model="squeeze-ernet", precision=precision, root_dir=str(data),
            train_split=splits["train"], val_split=splits["val"],
            test_split=splits["test"], checkpoint_dir=str(
                work / f"train_{precision}" / "saves"),
            log_dir=str(work / f"train_{precision}" / "logs"), **kw)
        _count_from_zero()
        t0 = time.perf_counter()
        state, history = train_model(config)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        batch = config.batch_size
        eval_batches = (-(-AIDER_SPLITS["val"] // batch)
                        * len(history["val_loss"])
                        + -(-AIDER_SPLITS["test"] // batch))
        _read_launches(f"aider_train/{precision}", launches,
                       _only(precision, 4 * eval_batches))
        losses = history["train_loss"]
        records[precision] = {"seconds": seconds, "steps": state.step,
                              "batch": batch, "history": history,
                              "eval_batches": eval_batches}
        say(f"aider_train {precision} on the card: {len(losses)} epochs, "
            f"{state.step} steps of batch {batch}, train loss "
            f"{['%.4f' % v for v in losses]}, val_acc "
            f"{['%.3f' % v for v in history['val_acc']]}, {seconds:.1f} s; "
            f"{precision} ACFF launches {4 * eval_batches} "
            f"({eval_batches} eval batches), 0 in the train steps [{card}]")
        if not np.all(np.isfinite(losses + history["val_loss"])):
            raise AssertionError(f"aider_train {precision}: non-finite loss")
        if precision == "fp32" and not (losses[-1] < losses[0] and max(
                history["val_acc"]) >= 0.4):
            raise AssertionError("aider_train fp32: the loss did not fall or "
                                 "val_acc stayed under 0.4")
        configs[precision] = config
    return records, configs["fp32"]


def phase_train_eval(card, config):
    """Phase 9c: on the trained weights, the eval model's kernels against
    the blocks run layer by layer (fp32 and bf16 engine gates), and ROADMAP
    fault 4 on the card: evaluate, step, evaluate again."""
    from rtdm_tpu_torch.core.precision import FP32_POLICY, tf32
    from rtdm_tpu_torch.data.aider import AiderDataset, normalize_batch
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.models.acff import layer_by_layer
    from rtdm_tpu_torch.models.io import (load_variables,
                                          torch_state_dict_from_variables)
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import make_optimizer
    from rtdm_tpu_torch.train.trainer import Trainer
    state_dict = torch_state_dict_from_variables(
        load_variables(config.weights))
    ds = AiderDataset(config.val_split, config.root_dir, 140)
    frames = np.stack([ds.load(i)[0] for i in range(len(ds))])
    x = normalize_batch(torch.from_numpy(frames).cuda())
    records = {}
    for quant, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = create_model("squeeze-ernet", device="cuda")
        model.load_state_dict(state_dict)
        for p in model.parameters():
            p.data = p.data.to(dtype)
        with torch.no_grad(), tf32(quant != "fp32"):
            _count_from_zero()
            got = model(x.to(dtype), apply_softmax=False).float()
            _read_launches(f"train eval kernel check/{quant}", {},
                           _only(quant, 4))
            with layer_by_layer(model):
                want = model(x.to(dtype), apply_softmax=False).float()
        err = ((got - want).abs().max() / want.abs().max()).item()
        records[quant] = err
        say(f"trained weights, {quant}: kernel eval vs the blocks layer by "
            f"layer {err:.3e} of max |logit| (gate {LOGIT_REL_TOL[quant]})")
        if err > LOGIT_REL_TOL[quant]:
            raise AssertionError(f"trained weights {quant}: kernel eval "
                                 f"{err} from the layers")
    model = create_model("squeeze-ernet", device="cuda", dropout_rate=0.0)
    model.load_state_dict(state_dict)
    trainer = Trainer(model, make_optimizer("sgd", 0.05),
                      make_classification_loss("label_smoothing"),
                      policy=FP32_POLICY)
    state = trainer.init_state()
    y = torch.from_numpy(ds.labels).long().cuda()
    view = trainer.eval_step.model

    def logits():
        with torch.no_grad(), tf32(False):
            return view(x, apply_softmax=False).float()

    trainer.eval_step(state, x, y, len(y))
    first = logits()
    state, _ = trainer.train_step(state, x, y, 0)
    trainer.eval_step(state, x, y, len(y))
    second = logits()
    fresh = create_model("squeeze-ernet", device="cuda")
    fresh.load_state_dict(state.model.state_dict())
    with torch.no_grad(), tf32(False), layer_by_layer(fresh):
        want = fresh(x, apply_softmax=False).float()
    err = ((second - want).abs().max() / want.abs().max()).item()
    moved = ((second - first).abs().max() / first.abs().max()).item()
    records["fault1"] = {"after_step_vs_layers": err, "moved": moved}
    say(f"fault 4 on the card: eval after a step vs the new weights layer "
        f"by layer {err:.3e} of max |logit| (gate {LOGIT_REL_TOL['fp32']}); "
        f"the step moved the logits {moved:.3e}")
    if err > LOGIT_REL_TOL["fp32"] or moved <= LOGIT_REL_TOL["fp32"]:
        raise AssertionError("fault 4: the eval after a step does not see "
                             "the new weights")
    return records


def phase_train_engine(card, config, golden):
    """Phase 9d: the port's Engine built from the trained .npz on the card,
    against the port on the CPU, on the docs/examples frames."""
    from rtdm_tpu_torch.export.engine import build_engine
    from rtdm_tpu_torch.models.io import load_variables
    variables = load_variables(config.weights)
    frames = golden["frames_140"]
    records = {}
    for quant in ("fp32", "bf16"):
        got = build_engine("squeeze-ernet", variables, quant, batch_size=16)(
            frames)
        want = build_engine("squeeze-ernet", variables, quant, batch_size=16,
                            device="cpu")(frames)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        records[quant] = err
        say(f"engine from the trained .npz, {quant}: card vs CPU port "
            f"{err:.3e} of max |prob| (gate {LOGIT_REL_TOL[quant]}), argmax "
            f"equal {bool((got.argmax(1) == want.argmax(1)).all())}")
        if err > LOGIT_REL_TOL[quant]:
            raise AssertionError(f"trained engine {quant}: card vs CPU {err}")
    return records


def phase_train_timing(card):
    """Phase 9e: the train step (grad accumulation 2, as the CLI's default)
    at batch 64 and 256 in fp32 and bf16: median and p90 ms, images/s,
    peak memory; the eval step's ms; and a profiler split of one bf16 step
    at batch 256."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rtdm_tpu_torch.core.precision import policy_from_name
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import make_optimizer, make_schedule
    from rtdm_tpu_torch.train.trainer import Trainer
    rng = np.random.default_rng(SEED)
    records = {}
    for precision in ("fp32", "bf16"):
        for batch in (64, 256):
            model = create_model("squeeze-ernet", device="cuda")
            tx = make_optimizer("adamw", make_schedule("onecycle", 3e-4, 100))
            trainer = Trainer(model, tx, make_classification_loss(
                "label_smoothing"), policy=policy_from_name(precision),
                grad_accum_steps=2, mixup_alpha=0.2, cutmix_alpha=0.1)
            state = trainer.init_state()
            x = torch.from_numpy(rng.normal(size=(batch, 140, 140, 3)).astype(
                np.float32)).cuda()
            y = torch.from_numpy(rng.integers(0, 5, batch)).cuda()
            for _ in range(TRAIN_WARM):
                trainer.train_step(state, x, y, 1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            samples = []
            for _ in range(TRAIN_TIMED):
                t0 = time.perf_counter()
                _, m = trainer.train_step(state, x, y, 1)
                float(m["loss"])
                samples.append((time.perf_counter() - t0) * 1e3)
            med, p90 = _percentiles(samples)
            mem = torch.cuda.max_memory_allocated()
            eval_ms = []
            for _ in range(TRAIN_TIMED):
                t0 = time.perf_counter()
                int(trainer.eval_step(state, x, y, batch)["correct"])
                eval_ms.append((time.perf_counter() - t0) * 1e3)
            emed, _ = _percentiles(eval_ms)
            records[f"{precision}/{batch}"] = {
                "step_ms_median": med, "step_ms_p90": p90,
                "images_per_s": batch * 1e3 / med, "peak_memory_B": mem,
                "eval_ms_median": emed}
            say(f"train step {precision} batch {batch} (accum 2, mixup/"
                f"cutmix): median {med:.3f} ms, p90 {p90:.3f} ms "
                f"(n={TRAIN_TIMED}, host clock), {batch * 1e3 / med:.1f} "
                f"images/s, peak memory {mem} B; eval step {emed:.3f} ms "
                f"[{card}]")
    # profiler split of one bf16 step at batch 256 (state from the loop)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = trainer.train_step(state, x, y, 1)
        float(m["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: a user range (the optimizer's step) spans its kernels
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("Optimizer.")), reverse=True)
    busy = sum(r[0] for r in rows)
    shares = {}
    for us, _, name in rows:
        kind = next(k for k, pattern in TRAIN_KERNEL_KINDS
                    if re.search(pattern, name))
        shares[kind] = shares.get(kind, 0.0) + us
    records["profile_bf16_256"] = {
        "wall_us": wall_us, "busy_us": busy, "launches": sum(
            r[1] for r in rows), "by_kind_us": shares,
        "top": [(name[:80], us, n) for us, n, name in rows[:15]]}
    if not rows:
        say("train profile: the profiler recorded no device time; breakdown "
            "not measured")
        return records
    say(f"train profile bf16 batch 256, one step: device busy {busy:.1f} us "
        f"of {wall_us:.1f} us host clock ({100 * busy / wall_us:.1f}% "
        f"busy), {records['profile_bf16_256']['launches']} kernels [{card}]")
    for kind, us in sorted(shares.items(), key=lambda kv: -kv[1]):
        say(f"  {us:9.1f} us {100 * us / busy:5.1f}% {kind}")
    for us, n, name in rows[:15]:
        say(f"  {us:9.1f} us {100 * us / busy:5.1f}% x{n} {name[:90]}")
    return records


def phase_training(card, work, golden):
    """Phase 9: training on the card (9a-9e). Returns the records and, by
    path, the ACFF launches of the train_model runs."""
    t0 = time.perf_counter()
    launches = {}
    records = {"pool_backward": phase_train_pool_check(),
               "golden": phase_train_golden(card)}
    records["train_model"], fp32_config = phase_train_model(card, work,
                                                            launches)
    records["eval"] = phase_train_eval(card, fp32_config)
    records["engine"] = phase_train_engine(card, fp32_config, golden)
    records["timing"] = phase_train_timing(card)
    records["seconds"] = time.perf_counter() - t0
    say(f"phase 9: {records['seconds']:.1f} s")
    return records, launches


# --- phase 10: detector training on the card ------------------------------

GOLDEN_YOLO = GOLDEN.with_name("yolo_train.npz")
# case: gates on (loss and components, grad_norm, params, stats, ema), each
# relative (per step; per leaf over its max |value|), set over the port's
# readings on the CPU against the golden in fp32 and in float64, which are
# alike (JAX's own fp32 rounding): a (6.6e-5, 1.4e-5, 8.4e-8, 2.3e-6,
# 2.3e-6), b (1.0e-5, 1.3e-6, 2.4e-7, -, -), c bf16 (2.5e-3, 6.5e-3,
# 3.5e-4, 4.8e-5, 3.5e-4) (tests/test_torch_yolo_train.py), held on the
# card too, against the golden and against the port on the CPU
YOLO_GATES = {"a": (3e-4, 1e-4, 1e-6, 1e-5, 1e-5),
              "b": (5e-5, 1e-5, 2e-6, 0.0, 0.0),
              "c": (1e-2, 3e-2, 2e-3, 5e-4, 2e-3)}
YOLO_GATE_NAMES = ("loss", "grad_norm", "params", "stats", "ema")
# the synthetic set of phase 10b (data/synth.py, the generator's mixed
# native sizes) and the timing of 10c
SYNTH_SPLITS = (96, 16)
YOLO_TIMED = 10
YOLO_WARM = 3
YOLO_KERNEL_KINDS = (
    ("convs (fwd, dgrad, wgrad)",
     r"xmma|implicit|gemm|conv|cudnn|sm90_|sm80_|winograd"),
    ("cuDNN layout transforms", r"tensorTransform|nchwTo|nhwcTo"),
    ("reductions (BN statistics and grads, loss sums, grad norm)",
     r"reduce_kernel|Reduce"),
    ("loss gathers and scatters", r"index|scatter|gather"),
    ("optimizer and EMA (foreach)", r"multi_tensor|foreach|sgd|SGD"),
    ("casts and copies", r"copy"),
    ("pools", r"pool"),
    ("elementwise (BN affine, SiLU, loss terms, clip)", r""))


def _yolo_golden():
    with np.load(GOLDEN_YOLO) as g:
        golden = dict(g)
    golden["spec"] = json.loads(str(golden["spec"]))
    return golden


def _lww_loss(is_v5, record):
    """The port's loss with ``tobj`` written by an index-put (the last
    write to a cell wins), counting in ``record['collisions']`` the valid
    candidates that share a cell with another of another value."""
    from rtdm_tpu_torch.train import yolo_loss as tl

    def obj_and_cls(p, ps, b_idx, a_idx, gj, gi, vmask, tcls, iou, hyp,
                    nc, mesh=None):
        bsz, na, ny, nx, _ = p.shape
        val = torch.where(vmask, (1.0 - hyp.gr)
                          + hyp.gr * iou.detach().clamp_min(0.0),
                          torch.zeros_like(iou))
        cell = ((b_idx * na + a_idx) * ny + gj) * nx + gi
        live = cell[vmask]
        uniq = torch.unique(torch.stack([live, val[vmask].double()
                                         .mul(1e6).round().long()]), dim=1)
        record["collisions"] += int(uniq.shape[1]
                                    - torch.unique(live).numel())
        order = torch.argsort(val, stable=True)
        tobj = p.new_zeros(bsz * na * ny * nx)
        tobj[cell[order].flip(0)] = val[order].flip(0)
        tobj = tobj.view(bsz, na, ny, nx)
        obj = tl._bce_logits(p[..., 4], tobj, hyp.obj_pw)
        if hyp.fl_gamma > 0:
            obj = tl._focal(obj, p[..., 4], tobj, hyp.fl_gamma,
                            hyp.fl_alpha)
        cls = torch.zeros((), device=p.device)
        if nc > 1:
            one = torch.nn.functional.one_hot(tcls, nc).to(p.dtype)
            bce = tl._bce_logits(ps[:, 5:], one, hyp.cls_pw)
            if hyp.fl_gamma > 0:
                bce = tl._focal(bce, ps[:, 5:], one, hyp.fl_gamma,
                                hyp.fl_alpha)
            cls = tl._masked_mean(bce.mean(-1), vmask)
        return obj.mean(), cls

    def loss(*args, **kwargs):
        saved = tl._obj_and_cls
        tl._obj_and_cls = obj_and_cls
        try:
            return (tl.yolo_loss_v5 if is_v5 else tl.yolo_loss)(*args,
                                                                **kwargs)
        finally:
            tl._obj_and_cls = saved
    return loss


def golden_yolo_case(golden, case, device, work, dtype=None,
                     bn_momentum=None, lww_record=None, steps=None,
                     mesh=None, loss_fn=None):
    """The port's detector train step (``cli/yolo_train.py``'s, as its
    ``train`` builds it) on ``device`` in one case of the detector train
    golden: per step the loss, its components, the gradients' global norm
    and the golden's leaves (``vars``, ``ema``), flat in the JAX layout.
    ``dtype`` float64 runs the model and the loss in float64 (the gate
    readings); ``bn_momentum`` and ``lww_record`` make the controls;
    ``steps`` cuts the run to its first steps; ``mesh`` runs the
    data-parallel step over it (every rank handed the whole batch);
    ``loss_fn`` replaces the case's loss."""
    from rtdm_tpu_torch.cli import yolo_train as yt
    from rtdm_tpu_torch.data.example_set import write_engine_as_cfg
    from rtdm_tpu_torch.models.io import (flatten_tree,
                                          variables_from_torch_state_dict)
    from rtdm_tpu_torch.models.layers import BatchNorm
    from rtdm_tpu_torch.train.ema import ema_init
    sp = golden["spec"]
    engine, precision, accumulate, use_ema = sp["cases"][case]
    cfg, weights = write_engine_as_cfg(ENGINES / engine,
                                       Path(work) / f"yolo_{case}")
    args = yt.parse_args(["--cfg", cfg, "--weights", weights, "--img-size",
                          str(sp["img_size"]), "--precision", precision,
                          "--device", str(device)] + sp["flags"])
    is_v5 = cfg.endswith(".yaml")
    model, heads = yt.load_model(cfg, weights, args.img_size,
                                 2 if is_v5 else None, device)
    default_loss, hyp = yt.build_loss(args, {}, heads, 2, is_v5)
    loss_fn = loss_fn or default_loss
    if lww_record is not None:
        loss_fn = _lww_loss(is_v5, lww_record)
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    if dtype == torch.float64:
        model.double()
        dt = torch.float64
    if bn_momentum is not None:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.momentum = bn_momentum
    opt = yt.build_optimizer(args, model, is_v5, {}, sp["steps_per_epoch"],
                             sp["total_steps"])
    ema = ema_init(model) if use_ema else None
    step = yt.make_train_step(model, heads, loss_fn, hyp, dt, accumulate,
                              args.img_size, ema, mesh)
    images = torch.from_numpy(golden["images"]).to(device)
    labels = torch.from_numpy(golden["labels"]).to(device)
    nlab = torch.from_numpy(golden["num_labels"]).to(device)
    leaves = json.loads(str(golden[f"{case}/leaves"]))
    out = {"loss": [], "comps": [], "grad_norm": [],
           "vars": {k: [] for k in leaves["params"] + leaves["stats"]},
           "ema": {k: [] for k in leaves["ema"]}}
    for it in range(steps or sp["steps"]):
        loss, comps, norm = step(opt, images, labels, nlab, it, sp["seed"],
                                 train_size=args.img_size, update_bn=is_v5)
        out["loss"].append(float(loss))
        out["comps"].append(comps.double().cpu().numpy())
        out["grad_norm"].append(float(norm))
        for name, tree in (("vars", model.state_dict()), ("ema", ema)):
            if out[name]:
                flat = flatten_tree(variables_from_torch_state_dict(tree))
                for k in out[name]:
                    out[name][k].append(flat[k].copy())   # not a view
    return {"loss": np.array(out["loss"]), "comps": np.stack(out["comps"]),
            "grad_norm": np.array(out["grad_norm"]),
            "vars": {k: np.stack(v) for k, v in out["vars"].items()},
            "ema": {k: np.stack(v) for k, v in out["ema"].items()}}


def golden_yolo_ref(golden, case, steps=None):
    """A golden case in ``golden_yolo_case``'s layout (its first ``steps``
    steps)."""
    pre, cut = f"{case}/", slice(0, steps)
    return {"loss": golden[pre + "loss"][cut],
            "comps": golden[pre + "comps"][cut],
            "grad_norm": golden[pre + "grad_norm"][cut],
            "vars": {k[len(pre) + 5:]: v[cut] for k, v in golden.items()
                     if k.startswith(pre + "vars/")},
            "ema": {k[len(pre) + 4:]: v[cut] for k, v in golden.items()
                    if k.startswith(pre + "ema/")}}


def yolo_gaps(ref, run):
    """(loss and components, grad_norm, params, stats, ema) gaps of ``run``
    to ``ref``: relative per step (each component to itself), each leaf
    over its max |value|; 0 where the case has no such leaf."""
    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a, np.float64) - b)
                            / np.maximum(np.abs(b), 1e-30)))

    def leaf(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max()
                     / max(np.abs(b).max(), 1e-30))

    loss = max(rel(run["loss"], ref["loss"]), rel(run["comps"],
                                                  ref["comps"]))
    params = [leaf(run["vars"][k], v) for k, v in ref["vars"].items()
              if k.startswith("params/")]
    stats = [leaf(run["vars"][k], v) for k, v in ref["vars"].items()
             if k.startswith("batch_stats/")]
    ema = [leaf(run["ema"][k], v) for k, v in ref["ema"].items()]
    return (loss, rel(run["grad_norm"], ref["grad_norm"]),
            max(params, default=0.0), max(stats, default=0.0),
            max(ema, default=0.0))


def _fmt(gaps):
    return ", ".join(f"{n} {g:.3e}" for n, g in zip(YOLO_GATE_NAMES, gaps))


def phase_yolo_golden(card, work):
    """Phase 10a: the detector train golden's three cases on the card
    against the golden and the port on the CPU (YOLO_GATES), and two
    controls on case a: BatchNorm at torch's momentum 0.1 (ROADMAP fault 8)
    must miss the statistics gate; a last-write-wins ``tobj`` must miss the
    loss gate, or count no cell where two candidates collide."""
    golden = _yolo_golden()
    records = {}
    for case in sorted(golden["spec"]["cases"]):
        ref = golden_yolo_ref(golden, case)
        t0 = time.perf_counter()
        card_run = golden_yolo_case(golden, case, "cuda", work)
        t1 = time.perf_counter()
        cpu_run = golden_yolo_case(golden, case, "cpu", work)
        t2 = time.perf_counter()
        to_golden, to_cpu = yolo_gaps(ref, card_run), yolo_gaps(cpu_run,
                                                                card_run)
        gate = YOLO_GATES[case]
        records[case] = {"card_vs_golden": to_golden,
                         "card_vs_cpu_port": to_cpu,
                         "cpu_port_vs_golden": yolo_gaps(ref, cpu_run),
                         "gate": gate,
                         "loss": card_run["loss"].tolist(),
                         "card_s": t1 - t0, "cpu_s": t2 - t1}
        say(f"yolo train golden case {case} {golden['spec']['cases'][case]}:"
            f" card vs golden {_fmt(to_golden)}; vs the CPU port "
            f"{_fmt(to_cpu)}; gate {gate}; card {t1 - t0:.1f} s, CPU "
            f"{t2 - t1:.1f} s")
        if not all(g <= t for g, t in zip(to_golden + to_cpu, gate * 2)):
            raise AssertionError(f"yolo train golden case {case}: card gaps "
                                 f"{to_golden} / {to_cpu} over {gate}")
    ref = golden_yolo_ref(golden, "a")
    ctl = yolo_gaps(ref, golden_yolo_case(golden, "a", "cuda", work,
                                          bn_momentum=0.1))
    records["control_bn_momentum_0.1"] = ctl
    say(f"yolo golden control (BN momentum 0.1), case a: {_fmt(ctl)}")
    if ctl[3] <= YOLO_GATES["a"][3]:
        raise AssertionError("the BN momentum control met case a's "
                             "statistics gate")
    lww = {"collisions": 0}
    ctl = yolo_gaps(ref, golden_yolo_case(golden, "a", "cuda", work,
                                          lww_record=lww))
    records["control_last_write_wins"] = {"gaps": ctl, **lww}
    say(f"yolo golden control (last-write-wins tobj), case a: {_fmt(ctl)}; "
        f"{lww['collisions']} colliding candidates in its loss calls")
    if ctl[0] <= YOLO_GATES["a"][0] and lww["collisions"]:
        raise AssertionError("the last-write-wins control met case a's "
                             "loss gate on a batch with collisions")
    return records


def _yolo_flags(cfg, weights, data, out, v5):
    flags = ["--cfg", cfg, "--weights", weights, "--data", data,
             "--img-size", "416", "--batch-size", "16", "--nominal-batch",
             "64", "--no-plots", "--output", str(out), "--exist-ok",
             "--num-workers", "8", "--device", "cuda"]
    if v5:
        flags += ["--lr0", "0.01", "--momentum", "0.937", "--weight-decay",
                  "0.0005"]
    return flags


def phase_yolo_runs(card, work, launches):
    """Phase 10b: yolo_train on a synthetic set written by data/synth.py
    (SYNTH_SPLITS images at the generator's mixed native sizes):
    yolov5s-mini at 416, batch 16 of nominal 64 (accumulate 4), 3 epochs
    with EMA, mosaic and BN burn-in 2 (finite losses, the mAP computed,
    best.npz served by build_detector on the card), its --resume to a 4th
    epoch, and yolov4-tiny-mini 1 epoch --rect and 1 --multi-scale; each
    run's ACFF launches counted from 0 (none)."""
    from rtdm_tpu_torch.cli import yolo_train
    from rtdm_tpu_torch.data.example_set import write_engine_as_cfg
    from rtdm_tpu_torch.data.synth import generate_detection_dataset
    from rtdm_tpu_torch.export.detector import DetectorSpec, build_detector
    t0 = time.perf_counter()
    data, _ = generate_detection_dataset(work / "synth", *SYNTH_SPLITS,
                                         seed=SEED)
    say(f"synthetic set: {SYNTH_SPLITS[0]} + {SYNTH_SPLITS[1]} images "
        f"written in {time.perf_counter() - t0:.1f} s")
    engines = {e: write_engine_as_cfg(ENGINES / e, work / "yolo_cfg")
               for e in DETECTORS}
    cfg5, w5 = engines["yolov5s-mini_int8"]
    cfg3, w3 = engines["yolov4-tiny-mini_int8"]
    out5 = work / "yolo_v5"
    runs = {
        "v5s ema mosaic": _yolo_flags(cfg5, w5, data, out5, True)
        + ["--epochs", "3", "--ema", "--bn-burn-in", "2", "--no-strip"],
        "v5s resume": _yolo_flags(cfg5, w5, data, out5, True)
        + ["--epochs", "4", "--ema", "--bn-burn-in", "2", "--resume"],
        "v4-tiny rect": _yolo_flags(cfg3, w3, data, work / "yolo_rect",
                                    False) + ["--epochs", "1", "--rect"],
        "v4-tiny multi-scale": _yolo_flags(cfg3, w3, data,
                                           work / "yolo_ms", False)
        + ["--epochs", "1", "--multi-scale"],
    }
    records = {}
    for name, argv in runs.items():
        _count_from_zero()
        t0 = time.perf_counter()
        res, _ = _quiet(yolo_train.main, argv)
        seconds = time.perf_counter() - t0
        _read_launches(f"yolo_train/{name}", launches, _only("bf16", 0))
        losses = [h["loss"] for h in res["history"]]
        ev = res["last_eval"]
        records[name] = {"seconds": seconds, "losses": losses,
                         "map50": ev["map50"], "map": ev["map"],
                         "epochs": len(res["history"])}
        say(f"yolo_train {name}: {len(losses)} epochs, losses "
            f"{[[round(v, 4) for v in lv] for lv in losses]}, P "
            f"{ev['mp']:.3f} R {ev['mr']:.3f} mAP@0.5 {ev['map50']:.4f}, "
            f"{seconds:.1f} s, 0 ACFF launches [{card}]")
        if res["aborted"] or not np.all(np.isfinite(losses)):
            raise AssertionError(f"yolo_train {name}: non-finite loss")
        if name == "v5s resume" and len(res["history"]) != 4:
            raise AssertionError("--resume did not continue at epoch 4")
    det = build_detector(cfg5, str(out5 / "best.npz"), DetectorSpec(
        cfg_name="yolov5s.yaml", quant="fp32"), batch_size=4, num_classes=2,
        device="cuda")
    frames = np.ascontiguousarray(_yolo_golden()["images"][:4])
    got, count = det(frames)
    records["best_npz_detector"] = {"counts": count.tolist()}
    say(f"best.npz in build_detector on the card: counts {count.tolist()}")
    if not np.isfinite(got).all():
        raise AssertionError("the trained detector gave non-finite rows")
    return records, data, engines


def phase_yolo_timing(card, data, engines):
    """Phase 10c: yolov5s-mini at 416, fp32 and bf16: the train step at
    batch 16 (accumulate 1) and 64 (accumulate 4), median and p90 of
    YOLO_TIMED calls after YOLO_WARM, images/s, peak memory; the host
    loader's images/s with mosaic, apart from the step; a profiler split of
    one bf16 step at batch 16; the eval pass's ms per image."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rtdm_tpu_torch.cli import yolo_train as yt
    from rtdm_tpu_torch.data.odder import (DetectionBatchLoader,
                                           DetectionDataset, load_data_spec)
    from rtdm_tpu_torch.train.ema import ema_init
    cfg5, w5 = engines["yolov5s-mini_int8"]
    spec = load_data_spec(data)
    train_ds = DetectionDataset(spec["train"], 416, base_dir=spec["base"],
                                train=True, seed=SEED, num_classes=2)
    loader = DetectionBatchLoader(train_ds, 16, shuffle=True, drop_last=True,
                                  num_workers=8, seed=SEED)
    t0 = time.perf_counter()
    batches = [b for b, _ in loader]
    load_s = time.perf_counter() - t0
    n_img = 16 * len(batches)
    records = {"loader_images_per_s": n_img / load_s}
    say(f"host loader with mosaic at 416, 8 threads: {n_img} images in "
        f"{load_s:.3f} s, {n_img / load_s:.1f} images/s [{card}]")
    big = {k: np.concatenate([b[k] for b in batches[:4]]) for k in
           ("image", "labels", "num_labels")}
    args = yt.parse_args(["--cfg", cfg5, "--weights", w5, "--device",
                          "cuda", "--lr0", "0.01", "--momentum", "0.937"])
    for precision in ("fp32", "bf16"):
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        for batch, acc in ((16, 1), (64, 4)):
            model, heads = yt.load_model(cfg5, w5, 416, 2, "cuda")
            loss_fn, hyp = yt.build_loss(args, {}, heads, 2, True)
            opt = yt.build_optimizer(args, model, True, {}, 100, 1000)
            step = yt.make_train_step(model, heads, loss_fn, hyp, dtype,
                                      acc, 416, ema_init(model))
            x = torch.from_numpy(big["image"][:batch]).cuda()
            y = torch.from_numpy(big["labels"][:batch]).cuda()
            n = torch.from_numpy(big["num_labels"][:batch]).cuda()
            for it in range(YOLO_WARM):
                step(opt, x, y, n, it, SEED, 416)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            samples = []
            for it in range(YOLO_TIMED):
                t0 = time.perf_counter()
                loss, _, _ = step(opt, x, y, n, it, SEED, 416)
                float(loss)
                samples.append((time.perf_counter() - t0) * 1e3)
            med, p90 = _percentiles(samples)
            mem = torch.cuda.max_memory_allocated()
            records[f"{precision}/{batch}"] = {
                "step_ms_median": med, "step_ms_p90": p90,
                "images_per_s": batch * 1e3 / med, "peak_memory_B": mem}
            say(f"yolo train step {precision} batch {batch} (accumulate "
                f"{acc}, EMA): median {med:.3f} ms, p90 {p90:.3f} ms "
                f"(n={YOLO_TIMED}, host clock), {batch * 1e3 / med:.1f} "
                f"images/s, peak memory {mem} B [{card}]")
            if precision == "bf16" and batch == 16:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    loss, _, _ = step(opt, x, y, n, 99, SEED, 416)
                    float(loss)
                    wall_us = (time.perf_counter() - t0) * 1e6
                rows = sorted(((e.self_device_time_total, e.count, e.key)
                               for e in prof.key_averages()
                               if e.device_type == DeviceType.CUDA
                               and e.self_device_time_total > 0),
                              reverse=True)
                busy = sum(r[0] for r in rows)
                shares = {}
                for us, _, name in rows:
                    kind = next(k for k, pattern in YOLO_KERNEL_KINDS
                                if re.search(pattern, name))
                    shares[kind] = shares.get(kind, 0.0) + us
                records["profile_bf16_16"] = {
                    "wall_us": wall_us, "busy_us": busy,
                    "launches": sum(r[1] for r in rows),
                    "by_kind_us": shares,
                    "top": [(nm[:80], us, c) for us, c, nm in rows[:12]]}
                if not rows:
                    say("yolo train profile: no device time recorded; "
                        "breakdown not measured")
                else:
                    say(f"yolo train profile bf16 batch 16, one step: "
                        f"device busy {busy:.1f} us of {wall_us:.1f} us host "
                        f"clock ({100 * busy / wall_us:.1f}% busy), "
                        f"{records['profile_bf16_16']['launches']} kernels "
                        f"[{card}]")
                    for kind, us in sorted(shares.items(),
                                           key=lambda kv: -kv[1]):
                        say(f"  {us:9.1f} us {100 * us / busy:5.1f}% {kind}")
                    for us, c, nm in rows[:12]:
                        say(f"  {us:9.1f} us {100 * us / busy:5.1f}% x{c} "
                            f"{nm[:90]}")
            if batch == 16:
                ev = yt.EvalStep(model, heads, dtype, 416)
                ev.load(model.state_dict())
                ev(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    det, count = ev(x)
                    count.cpu()
                ms = (time.perf_counter() - t0) * 1e3 / (3 * batch)
                records[f"{precision}/eval_ms_per_image"] = ms
                say(f"yolo eval pass {precision} (batch {batch}, decode + NMS "
                    f"multi-label): {ms:.3f} ms/image [{card}]")
            del model, opt, step
            torch.cuda.empty_cache()
    return records


def phase_yolo_training(card, work):
    """Phase 10: detector training on the card (10a-10c). Returns the
    records and, by path, the ACFF launches of the yolo_train runs."""
    t0 = time.perf_counter()
    launches = {}
    records = {"golden": phase_yolo_golden(card, work)}
    records["runs"], data, engines = phase_yolo_runs(card, work, launches)
    records["timing"] = phase_yolo_timing(card, data, engines)
    records["seconds"] = time.perf_counter() - t0
    say(f"phase 10: {records['seconds']:.1f} s")
    return records, launches


# --- phase 11: native host IO ---------------------------------------------

GOLDEN_NATIVE = GOLDEN.with_name("native_io.npz")
# tests/torch_port_goldens.py: the rect bucket (h, w) at gain cap 1.0, the
# load_scaled sizes, the served classify frame's size
NATIVE_RECT = (320, 416)
NATIVE_SCALED = (416, 208)
NATIVE_SERVE_SIZE = 140
# the same rates with PIL, before the native decode was wired in, on
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the loader with mosaic on PIL
# tiles, rtdm-serve under load on PIL-decoded bodies
PIL_LOADER_IMAGES_PER_S = 101.9
PIL_SERVE_RPS = {"classify": 43.8, "detect": 36.1}


@contextlib.contextmanager
def _pil_only():
    """Every JPEG path as on a machine without the native library."""
    from rtdm_tpu_torch.data import native_io
    saved = native_io._load
    native_io._load = lambda: None
    try:
        yield
    finally:
        native_io._load = saved


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def phase_native_build():
    """Phase 11a: build the host library (run beside the nvcc build); fail
    unless it loads."""
    from rtdm_tpu_torch.data import native_io
    from rtdm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    if not native_io.available():
        raise AssertionError("native IO: the host library did not build or "
                             "load (see the warning above); the PIL "
                             "fallback is not accepted on the card")
    lib = kernels.host_library_path("rtdm_io")
    command, libjpeg = lib.with_suffix(".log").read_text().splitlines()[:2]
    record = {"seconds": time.perf_counter() - t0,
              "library": str(lib.relative_to(ROOT)),
              "command": command.split(": ", 1)[1],
              "libjpeg": libjpeg.split(": ", 1)[1]}
    return record


def _native_golden_checks(golden, work):
    """The port's native outputs against the golden's: (label, mismatches)
    for each call."""
    from rtdm_tpu_torch.data import native_io
    from rtdm_tpu_torch.data.example_set import write_example_set
    from rtdm_tpu_torch.data.odder import DetectionDataset, load_data_spec
    examples = [ROOT / "docs" / "examples" / str(n) for n in golden["names"]]
    bodies = [p.read_bytes() for p in examples]
    batch = native_io.decode_batch([str(p) for p in examples], 416)
    results = {
        "square": [native_io.decode_jpeg_letterbox(b, 416) for b in bodies],
        "rect": [native_io.decode_jpeg_letterbox_rect(b, *NATIVE_RECT,
                                                      gain_cap=1.0)
                 for b in bodies],
        "batch": [(batch[0][i], batch[1][i], tuple(batch[2][i]),
                   tuple(batch[3][i])) for i in range(len(bodies))]}
    out = {}
    for key, res in results.items():
        bad = sum(
            _digest(r[0]) != golden[f"{key}/digest"][i]
            or tuple(r[0].shape) != tuple(golden[f"{key}/shape"][i])
            or np.float32(r[1]) != golden[f"{key}/gain"][i]
            or tuple(np.float32(r[2])) != tuple(golden[f"{key}/pads"][i])
            or tuple(r[3]) != tuple(golden[f"{key}/orig_hw"][i])
            for i, r in enumerate(res))
        out[key] = bad
    spec = load_data_spec(write_example_set(work / "native_set", jpeg=True))
    ds = DetectionDataset(spec["valid"], 416, base_dir=str(spec["base"]))
    for size in NATIVE_SCALED:
        tiles = [ds.load_scaled(i, size) for i in range(len(ds))]
        out[f"scaled_{size}"] = sum(
            _digest(t) != golden[f"scaled_{size}/digest"][i]
            or tuple(t.shape) != tuple(golden[f"scaled_{size}/shape"][i])
            for i, t in enumerate(tiles))
    return out, bodies


def phase_native_served(card, launches, golden, bodies):
    """Phase 11b: the served classify frames and classes against the JAX
    server's, through the classify service on the bf16 engine."""
    import threading
    from rtdm_tpu_torch.cli.serve import _ClassifyService, classify_frame
    from rtdm_tpu_torch.models.ernet import CLASS_NAMES
    frames = np.stack([classify_frame(b, NATIVE_SERVE_SIZE) for b in bodies])
    if not np.array_equal(frames, golden["serve_frames"]):
        raise AssertionError("native IO: the served classify frames differ "
                             "from the JAX server's")
    svc = _ClassifyService(str(ENGINES / "squeeze-ernet_bf16"), 20.0, 2)
    replies = [None] * len(bodies)

    def call(i):
        replies[i] = svc(bodies[i])
    try:
        _count_from_zero()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        batches = svc.batcher.stats().as_dict()["batches"]
        path = (f"rtdm-serve classify bf16, native JPEG frames ({batches} "
                f"batches)")
        _read_launches(path, launches, _only("bf16", 4 * batches))
    finally:
        svc.batcher.close()
    if any(r is None for r in replies):
        raise AssertionError("native IO: a classify request did not finish")
    probs = np.array([[r["probs"][c] for c in CLASS_NAMES] for r in replies],
                     np.float32)
    classes = probs.argmax(1)
    top2 = np.sort(probs, 1)[:, -2:]
    margins = (top2[:, 1] - top2[:, 0]).tolist()
    for n, c, g, m in zip(golden["names"], classes, golden["serve_class"],
                          margins):
        say(f"  served {n}: class {c} (JAX {g}), top-2 margin {m:.4f}")
    dprob = float(np.abs(probs - golden["serve_probs"]).max())
    equal = int((classes == golden["serve_class"]).sum())
    say(f"native IO served classes: {equal}/{len(classes)} equal to the JAX "
        f"server's, max |dprob| {dprob:.3e}, {batches} batches [{card}]")
    if not np.array_equal(classes, golden["serve_class"]):
        raise AssertionError(f"native IO: served classes {classes.tolist()}"
                             f" != JAX's {golden['serve_class'].tolist()}")
    return {"classes": classes.tolist(), "margins": margins,
            "max_dprob": dprob, "batches": batches}


def _loader_rate(data):
    """The detector train loader with mosaic at 416 (phase 10's settings):
    images/s over one epoch of the set on 8 threads."""
    from rtdm_tpu_torch.data.odder import (DetectionBatchLoader,
                                           DetectionDataset, load_data_spec)
    spec = load_data_spec(data)
    ds = DetectionDataset(spec["train"], 416, base_dir=spec["base"],
                          train=True, seed=SEED, num_classes=2)
    loader = DetectionBatchLoader(ds, 16, shuffle=True, drop_last=True,
                                  num_workers=8, seed=SEED)
    t0 = time.perf_counter()
    n = sum(16 for _ in loader)
    return n / (time.perf_counter() - t0)


def phase_native_rates(card, work):
    """Phase 11c: host rates with the native decode and, in the same run,
    with PIL: the mosaic loader, serve_loadtest's decode_ms, the detector
    calibration load."""
    from rtdm_tpu_torch.cli.build_engine import load_detector_calib_images
    from rtdm_tpu_torch.cli.serve_loadtest import decode_breakdown
    data = str(work / "synth" / "data" / "synth.data")
    calib_dir = str(work / "synth" / "data" / "images" / "train")
    n_calib = len(list(Path(calib_dir).glob("*.jpg")))
    out = {}
    for route in ("native", "pil", "native again"):
        ctx = _pil_only() if route == "pil" else contextlib.nullcontext()
        with ctx:
            rec = {"loader_images_per_s": _loader_rate(data)}
            for service, size in (("classify", NATIVE_SERVE_SIZE),
                                  ("detect", 416)):
                rec[f"decode_ms_{service}"] = decode_breakdown(
                    size, service, reps=64)[2]
            t0 = time.perf_counter()
            calib = load_detector_calib_images(calib_dir, 416)
            rec["calib_images_per_s"] = n_calib / (time.perf_counter() - t0)
        if calib.shape != (n_calib, 416, 416, 3):
            raise AssertionError(f"calibration batch {calib.shape}")
        out[route] = rec
        say(f"host IO {route}: mosaic loader {rec['loader_images_per_s']:.1f}"
            f" images/s (8 threads, 416, {SYNTH_SPLITS[0]} synthetic JPEGs);"
            f" decode_ms classify {rec['decode_ms_classify']:.3f}, detect "
            f"{rec['decode_ms_detect']:.3f} (320x240 JPEG bodies); detector "
            f"calibration {rec['calib_images_per_s']:.1f} images/s "
            f"({n_calib} JPEGs) [{card}]")
    return out


def phase_native_io(card, work, build, serving, yolo_training):
    """Phase 11b-c. Returns the records and, by path, the ACFF launches."""
    t0 = time.perf_counter()
    launches = {}
    with np.load(GOLDEN_NATIVE) as g:
        golden = dict(g)
    mismatches, bodies = _native_golden_checks(golden, work)
    say("native IO vs the golden (frames differing, of 10): " +
        json.dumps(mismatches))
    if any(mismatches.values()):
        raise AssertionError(f"native IO: outputs differ from the JAX "
                             f"golden: {mismatches}")
    records = {"build": build, "golden_mismatches": mismatches,
               "served": phase_native_served(card, launches, golden, bodies),
               "rates": phase_native_rates(card, work)}
    loads = serving["serve"]["load"]
    records["before_after"] = {
        "loader_images_per_s": {
            "before (PIL)": PIL_LOADER_IMAGES_PER_S,
            "phase 10 (native)": yolo_training["timing"][
                "loader_images_per_s"]},
        "rtdm_serve_rps": {e: {"before (PIL)": PIL_SERVE_RPS[e],
                               "phase 8 (native)": loads[e]["rps"]}
                           for e in PIL_SERVE_RPS}}
    say("native IO, before (PIL) and after (this run, native): "
        + json.dumps(records["before_after"]) + f" [{card}]")
    records["seconds"] = time.perf_counter() - t0
    say(f"phase 11: {records['seconds']:.1f} s")
    return records, launches


# ---------------------------------------------------------------------------
# 12. multi-GPU: the data-parallel paths over torch.distributed


MULTI_ENGINES = {"bf16": "squeeze-ernet_bf16", "fp32": "squeeze-ernet_bf16",
                 "int8": "squeeze-ernet_int8"}
# a data-parallel step against the one-process step, every parameter and
# statistic: atol + rtol |want| (tests/test_torch_parallel_train.py's gate)
MULTI_STEP_TOL = (2e-4, 2e-5)
MULTI_TIMED = 10
GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "send_recv")
MULTI_RANKS = 2          # gloo ranks that share the one card
MULTI_CLASSIFIER_STEPS = 10


def _multi_frames(n=BATCH):
    """``n`` frames at 140: random crops (and mirror images) of the example
    photos resized to 180, so that every row's output differs from the
    others' and a row out of place shows."""
    from rtdm_tpu_torch.cli.aider_predict import load_image_rgb, preprocess
    photos = [preprocess(load_image_rgb(str(p)), 180)[0] for p in
              sorted((ROOT / "docs" / "examples").glob("*.jpg"))]
    rng = np.random.default_rng(SEED)
    out = np.empty((n, 140, 140, 3), np.uint8)
    for i in range(n):
        y, x = rng.integers(0, 41, 2)
        crop = photos[i % len(photos)][y:y + 140, x:x + 140]
        out[i] = crop[:, ::-1] if rng.random() < 0.5 else crop
    return out


def _multi_engine(quant, mesh=None, batch=BATCH):
    """The committed Squeeze_ErNET engine of ``quant`` (fp32: the bf16
    engine's weights) at ``batch``, data-parallel over ``mesh``."""
    from rtdm_tpu_torch.export.engine import Engine
    eng = Engine.load(str(ENGINES / MULTI_ENGINES[quant]), mesh=mesh)
    if quant == "fp32" or batch != eng.spec.batch_size:
        eng = Engine(dataclasses.replace(eng.spec, quant=quant,
                                         batch_size=batch),
                     eng.variables, eng.act_scales if quant == "int8"
                     else None, mesh=mesh)
    return eng


def _step_excess(got, want):
    """The largest |got - want| / (atol + rtol |want|) over the leaves
    (<= 1 meets MULTI_STEP_TOL)."""
    rtol, atol = MULTI_STEP_TOL
    return max(float((np.abs(got[k] - want[k])
                      / (atol + rtol * np.abs(want[k]))).max())
               for k in want)


def elastic_leg(mesh, directory, restore, device="cuda", batch=16):
    """The elastic leg (__graft_entry__._dryrun_elastic): adamw onecycle,
    clip 1.0, label smoothing, dropout 0.2, two microbatches of one fixed
    batch on the mesh's device (else ``device``); without ``restore``: 2
    steps, save, 2 more (the uninterrupted continuation); with it:
    restore, the same 2. -> (pre losses, continuation losses, the step
    saved or restored)."""
    from rtdm_tpu_torch.core.precision import FP32_POLICY
    from rtdm_tpu_torch.data.aider import normalize_batch
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.train.checkpoint import CheckpointManager
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import make_optimizer, make_schedule
    from rtdm_tpu_torch.train.trainer import Trainer
    rng = np.random.default_rng(7)
    device = mesh.device if mesh is not None else torch.device(device)
    x = normalize_batch(torch.from_numpy(rng.integers(
        0, 255, (batch, 140, 140, 3), dtype=np.uint8)).to(device))
    y = torch.from_numpy(rng.integers(0, 5, (batch,))).long().to(device)
    trainer = Trainer(create_model("squeeze-ernet", device=device,
                                   dropout_rate=0.2),
                      make_optimizer("adamw", make_schedule(
                          "onecycle", 3e-4, 100), weight_decay=0.01,
                          grad_clip=1.0),
                      make_classification_loss("label_smoothing"),
                      policy=FP32_POLICY, grad_accum_steps=2, mesh=mesh)
    state = trainer.init_state()
    mgr = CheckpointManager(str(directory), mesh)

    def run(state, key0):
        losses = []
        for i in range(2):
            state, m = trainer.train_step(state, x, y, key0 + i)
            losses.append(float(m["loss"]))
        return state, losses

    if restore:
        state, meta = mgr.restore("elastic", state)
        return meta["pre_losses"], run(state, 200)[1], state.step - 2
    state, pre = run(state, 100)
    mgr.save("elastic", state, metadata={"pre_losses": pre})
    return pre, run(state, 200)[1], state.step - 2


def flat_yolo_run(run, prefix=""):
    """A ``golden_yolo_case`` run as one flat dict (for an ``.npz``)."""
    out = {f"{prefix}{k}": run[k] for k in ("loss", "comps", "grad_norm")}
    out.update({f"{prefix}vars/{k}": v for k, v in run["vars"].items()})
    out.update({f"{prefix}ema/{k}": v for k, v in run["ema"].items()})
    return out


def unflat_yolo_run(res, prefix=""):
    """``flat_yolo_run``'s inverse."""
    def part(name):
        head = f"{prefix}{name}/"
        return {k[len(head):]: v for k, v in res.items()
                if k.startswith(head)}
    return {**{k: res[prefix + k] for k in ("loss", "comps", "grad_norm")},
            "vars": part("vars"), "ema": part("ema")}


def multi_gpu_rank(rank: int, world: int, store: str, out: str) -> None:
    """Phase 12c, one of MULTI_RANKS processes that share the card over
    gloo (the port's collectives stage the CUDA tensors through the host):
    the data-parallel engines with this rank's ACFF launches, the
    classifier and yolov5s-mini train steps, the halo conv and the elastic
    leg's save; writes ``<out>/rank<r>.npz``."""
    from rtdm_tpu_torch.core.mesh import (create_mesh, distributed_init,
                                          local_mesh)
    from rtdm_tpu_torch.ops import kernels
    from rtdm_tpu_torch.ops.acff import LAUNCHES
    from rtdm_tpu_torch.ops.convpool import conv2d
    from rtdm_tpu_torch.parallel.comms import all_gather_along
    from rtdm_tpu_torch.parallel.shard import spatial_shard_conv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build("acff")
    distributed_init(init_method=store, num_processes=world,
                     process_id=rank, device="cuda", backend="gloo")
    mesh = local_mesh(device="cuda")
    res, frames = {}, _multi_frames()
    for quant in MULTI_ENGINES:
        eng = _multi_engine(quant, mesh)
        eng(frames[:1])                    # warm-up
        torch.cuda.synchronize()
        _count_from_zero()
        res[f"engine/{quant}"] = eng(frames)
        res[f"launches/{quant}"] = LAUNCHES[quant]
    metrics, final = golden_train_case(_train_golden(), "a", "cuda",
                                       mesh=mesh)
    res.update({f"train/{k}": v for k, v in metrics.items()})
    res.update({f"train/final/{k}": v for k, v in final.items()})
    run = golden_yolo_case(_yolo_golden(), "a", "cuda",
                           Path(out) / f"yolo{rank}", steps=1, mesh=mesh)
    res.update(flat_yolo_run(run, "yolo/"))
    smesh = create_mesh((world,), ("spatial",), "cuda")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 64, 32, 8)).astype(
        np.float32)).cuda()
    k = torch.from_numpy((rng.normal(size=(16, 8, 3, 3)) * 0.1).astype(
        np.float32)).cuda()
    rows = 64 // world
    got = all_gather_along(spatial_shard_conv(
        x[:, rank * rows:(rank + 1) * rows], k, smesh), smesh, "spatial",
        axis=1)
    res["spatial_err"] = float((got - conv2d(x, k, None, 1, 1)).abs().max())
    pre, cont, _ = elastic_leg(mesh, Path(out) / "elastic", restore=False)
    res["elastic/pre"], res["elastic/cont"] = np.array(pre), np.array(cont)
    np.savez(Path(out) / f"rank{rank}.npz",
             **{k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                for k, v in res.items()})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def gloo_probe_rank(op: str, rank: int, world: int, store: str,
                    out: str) -> None:
    """Phase 12b, one rank: gloo's own ``op`` on a CUDA tensor of the one
    card, with no staging; writes what came to ``out``."""
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=store, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    x = torch.full((1024,), float(rank + 1), device="cuda")
    try:
        if op == "all_reduce":
            dist.all_reduce(x)
            ok = float(x[0]) == sum(range(1, world + 1))
        elif op == "broadcast":
            dist.broadcast(x, 0)
            ok = float(x[-1]) == 1.0
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            ok = [float(p[0]) for p in parts] == [float(r + 1)
                                                 for r in range(world)]
        else:
            peer = (rank + 1) % world
            got = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, peer),
                    dist.P2POp(dist.irecv, got, (rank - 1) % world)]):
                req.wait()
            ok = float(got[0]) == float((rank - 1) % world + 1)
        torch.cuda.synchronize()
        result = "works" if ok else "wrong result"
    except RuntimeError as e:
        result = f"refused: {str(e).splitlines()[0][:160]}"
    Path(out).write_text(result)
    dist.destroy_process_group()


def _spawn(code: str, n: int, log_dir: Path, tag: str):
    """``n`` python processes running ``code`` (with RANK set), from the
    checkout's root."""
    procs = []
    for rank in range(n):
        log = open(log_dir / f"{tag}.{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code.replace("RANK", str(rank))],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, timeout):
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [p.returncode for p, _ in procs]


def phase_multi_gpu(card, work, launches):
    """Phase 12: (b) which of gloo's collectives take CUDA tensors
    (GLOO_PROBE_OPS, each in its own pair of processes, joined before (a)
    times anything), (a) NCCL at world size 1 in this process, (c)
    MULTI_RANKS gloo ranks that share the card through the port's
    collectives, then the elastic ladder's last leg in this process.
    Returns the records."""
    import torch.distributed as dist

    from rtdm_tpu_torch.core.mesh import (create_mesh, distributed_init,
                                          local_mesh)
    from rtdm_tpu_torch.ops.convpool import conv2d
    from rtdm_tpu_torch.parallel.shard import spatial_shard_conv
    t_phase = time.perf_counter()
    work = work / "multi_gpu"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    probes = {op: _spawn(
        f"import chip_smoke; chip_smoke.gloo_probe_rank({op!r}, RANK, 2, "
        f"'file://{work / ('probe_' + op)}', '{work / op}.RANK')", 2, work,
        f"probe_{op}") for op in GLOO_PROBE_OPS}
    rec = {"card": card}

    # (a) NCCL, world size 1: first what is checked and not timed, while
    # the probes run
    distributed_init(init_method=f"file://{work / 'nccl_store'}",
                     num_processes=1, process_id=0, device="cuda")
    mesh = local_mesh(device="cuda")
    rec["backend"] = dist.get_backend()
    if mesh.groups["data"] is not None:
        raise AssertionError("a mesh of one rank holds a process group: its "
                             "collectives would not be the identity")
    frames = _multi_frames()
    engines, ref = {}, {}
    for quant in MULTI_ENGINES:
        plain, dp = _multi_engine(quant), _multi_engine(quant, mesh)
        want = plain(frames)
        dp(frames[:1])
        torch.cuda.synchronize()
        _count_from_zero()
        got = dp(frames)
        _read_launches(f"multi-GPU engine {quant}, NCCL mesh of 1",
                       launches, _only(quant, 4))
        if not np.array_equal(got, want):
            raise AssertionError(f"DP engine {quant}: not bit-equal to the "
                                 f"engine without a mesh (max |d| "
                                 f"{np.abs(got - want).max():.3e})")
        ref[f"engine/{quant}"] = want
        engines[quant] = (plain, dp)

    golden = _train_golden()
    want_m, want_f = golden_train_case(golden, "a", "cuda")
    got_m, got_f = golden_train_case(golden, "a", "cuda", mesh=mesh)
    ref["train"] = (want_m, want_f)
    rec["train_step_excess"] = _step_excess(got_f, want_f)
    rec["train_loss_gap"] = float(np.abs(got_m["loss"] - want_m["loss"]).max()
                                  / np.abs(want_m["loss"]).max())
    ygold = _yolo_golden()
    ywant = golden_yolo_case(ygold, "a", "cuda", work / "yolo_plain",
                             steps=1)
    ygot = golden_yolo_case(ygold, "a", "cuda", work / "yolo_dp", steps=1,
                            mesh=mesh)
    ref["yolo"] = ywant
    rec["yolo_step_gaps"] = yolo_gaps(ywant, ygot)
    say(f"multi-GPU train steps, NCCL mesh of 1 against no mesh: classifier "
        f"golden case a at {rec['train_step_excess']:.3f} of the "
        f"{MULTI_STEP_TOL} gate (loss gap {rec['train_loss_gap']:.2e}); "
        f"yolov5s-mini case a: {_fmt(rec['yolo_step_gaps'])}")
    if rec["train_step_excess"] > 1.0 or rec["train_loss_gap"] > 1e-4:
        raise AssertionError("DP classifier step differs from the step "
                             "without a mesh")
    if any(g > t for g, t in zip(rec["yolo_step_gaps"], YOLO_GATES["a"])):
        raise AssertionError("DP yolov5s-mini step differs from the step "
                             "without a mesh")
    # the engines of (c)'s ranks' rows, one engine call a rank here
    per = BATCH // MULTI_RANKS
    for quant in MULTI_ENGINES:
        half = _multi_engine(quant, batch=per)
        ref[f"rows/{quant}"] = np.concatenate([
            half(frames[r * per:(r + 1) * per]) for r in range(MULTI_RANKS)])
        apart = float(np.abs(ref[f"rows/{quant}"][:per]
                             - ref[f"rows/{quant}"][per:2 * per]).max())
        if apart < 1e-3:
            raise AssertionError(f"engine {quant}: the ranks' rows give "
                                 f"outputs {apart:.2e} apart; a row out of "
                                 "place would not show")

    # (b) which of gloo's own collectives take CUDA tensors
    probe = {}
    for op, procs in probes.items():
        rcs = _join(procs, 120)
        texts = [(work / f"{op}.{r}").read_text()
                 if (work / f"{op}.{r}").exists() else None
                 for r in range(2)]
        if texts == ["works", "works"]:
            probe[op] = "works"
        elif None in texts:
            probe[op] = f"aborts a process (exit codes {rcs}; {texts})"
        else:
            probe[op] = f"refused: {texts}"
    rec["gloo_cuda_probe"] = probe
    say("gloo on CUDA tensors, 2 ranks on the one card: " + json.dumps(probe))

    # (a), timed: no other process runs now
    timed = {}
    for quant, (plain, dp) in engines.items():
        times = {"plain": [], "dp": []}
        for _ in range(MULTI_TIMED):    # in turns: plain, mesh, mesh, plain
            for label in ("plain", "dp", "dp", "plain"):
                t0 = time.perf_counter()
                (plain if label == "plain" else dp)(frames)
                times[label].append((time.perf_counter() - t0) * 1e3)
        times = {k: _percentiles(v) for k, v in times.items()}
        timed[quant] = {"bit_equal": True, "launches": 4,
                        "ms_median_p90": times}
        say(f"multi-GPU engine {quant} batch {BATCH}, NCCL mesh of 1: "
            f"bit-equal to no mesh, 4 {quant} ACFF launches; host ms "
            f"(median, p90) no mesh {times['plain']}, mesh {times['dp']} "
            f"[{card}]")
    rec["engines"] = timed
    # NCCL itself, on the group of one rank
    out = engines["bf16"][1].dispatch(frames)
    gathered = torch.empty_like(out)
    dist.all_gather_into_tensor(gathered, out)
    if not torch.equal(gathered, out):
        raise AssertionError("NCCL all-gather over one rank changed the "
                             "engine's output")
    rec["all_gather_ms"] = cuda_ms(
        lambda: dist.all_gather_into_tensor(gathered, out), 50)
    del engines

    # the five legs of dryrun_multichip, at world size 1
    from rtdm_tpu_torch.core.precision import FP32_POLICY
    from rtdm_tpu_torch.data.aider import normalize_batch
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import make_optimizer, make_schedule
    from rtdm_tpu_torch.train.trainer import Trainer
    # the DP step and the step without a mesh from one init, in turns
    trainers = {label: Trainer(create_model("squeeze-ernet"), make_optimizer(
        "adamw", make_schedule("onecycle", 3e-4, 100), weight_decay=0.01,
        grad_clip=1.0), make_classification_loss("label_smoothing"),
        policy=FP32_POLICY, grad_accum_steps=2, mesh=m)
        for label, m in (("dp", mesh), ("plain", None))}
    states = {label: t.init_state() for label, t in trainers.items()}
    x = normalize_batch(torch.from_numpy(frames[:16]).cuda())
    y = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5, (16,))).long().cuda()
    losses = {"dp": [], "plain": []}
    step_ms = {"dp": [], "plain": []}
    for i in range(MULTI_CLASSIFIER_STEPS):
        for label in (("dp", "plain") if i % 2 else ("plain", "dp")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[label], m = trainers[label].train_step(states[label], x,
                                                          y, 1 + i)
            losses[label].append(float(m["loss"]))
            step_ms[label].append((time.perf_counter() - t0) * 1e3)
    params = [p for p in states["dp"].model.parameters()]
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    summed = flat.clone()
    dist.all_reduce(summed)
    if not torch.equal(summed, flat):
        raise AssertionError("NCCL all-reduce over one rank changed the "
                             "gradients")
    rec["flat_all_reduce_ms"] = cuda_ms(lambda: dist.all_reduce(summed), 50)
    rec["grad_bytes"] = 4 * flat.numel()
    rec["dp_vs_plain_loss_gap"] = float(np.max(np.abs(
        np.array(losses["dp"]) - losses["plain"]) / np.array(
            losses["plain"])))
    losses = losses["dp"]
    smesh = create_mesh((1,), ("spatial",), "cuda")
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(size=(2, 64, 32, 8)).astype(
        np.float32)).cuda()
    k = torch.from_numpy((rng.normal(size=(16, 8, 3, 3)) * 0.1).astype(
        np.float32)).cuda()
    spatial_err = float((spatial_shard_conv(xs, k, smesh)
                         - conv2d(xs, k, None, 1, 1)).abs().max())
    probs = _multi_engine("fp32", mesh)(frames[:2])
    pre, cont, _ = elastic_leg(mesh, work / "elastic1", restore=False)
    _, resumed, _ = elastic_leg(mesh, work / "elastic1", restore=True)
    rec["legs_world_1"] = {
        "classifier_dp_losses": losses,
        "classifier_step_ms_median_p90": {
            k: _percentiles(v[1:]) for k, v in step_ms.items()},
        "yolo_dp_loss": float(ygot["loss"][0]),
        "spatial_halo_conv_max_err": spatial_err,
        "serving_dp_rowsum": float(probs.sum(1).mean()),
        "elastic": {"pre": pre, "continuation": cont, "resumed": resumed}}
    say(f"multi-GPU five legs, NCCL mesh of 1: classifier DP loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps, "
        f"{rec['dp_vs_plain_loss_gap']:.1e} from the steps without a mesh "
        f"(step ms median, p90, in turns "
        f"{rec['legs_world_1']['classifier_step_ms_median_p90']}), "
        f"yolo DP loss {rec['legs_world_1']['yolo_dp_loss']:.4f}, halo conv "
        f"max |err| {spatial_err:.2e}, serving rowsum "
        f"{rec['legs_world_1']['serving_dp_rowsum']:.6f}, elastic "
        f"continuation {cont} resumed {resumed}; NCCL on the group of one, "
        f"called directly: all-reduce of the {rec['grad_bytes']} gradient "
        f"bytes {rec['flat_all_reduce_ms']:.4f} ms, all-gather of the "
        f"(256, 5) probabilities {rec['all_gather_ms']:.4f} ms [{card}]")
    if not losses[-1] < losses[0] or rec["dp_vs_plain_loss_gap"] > 1e-4:
        raise AssertionError("classifier DP: the loss did not fall, or left "
                             "the steps without a mesh")
    if spatial_err > 1e-5 or abs(rec["legs_world_1"][
            "serving_dp_rowsum"] - 1.0) > 1e-5:
        raise AssertionError("halo conv or serving leg wrong at world 1")
    if not np.allclose(resumed, cont, rtol=2e-3):
        raise AssertionError(f"elastic: resumed {resumed} != {cont}")
    dist.destroy_process_group()

    # (c) MULTI_RANKS gloo ranks on the one card, through the port's comms
    t0 = time.perf_counter()
    rc = _join(_spawn(
        f"import chip_smoke; chip_smoke.multi_gpu_rank(RANK, {MULTI_RANKS}, "
        f"'file://{work / 'gloo_store'}', '{work}')", MULTI_RANKS, work,
        "rank"), 600)
    if any(rc):
        tail = (work / f"rank.{rc.index(next(c for c in rc if c))}.log"
                ).read_text()[-3000:]
        raise AssertionError(f"the gloo ranks failed ({rc}):\n{tail}")
    ranks = []
    for r in range(MULTI_RANKS):
        with np.load(work / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    gloo = {"seconds": time.perf_counter() - t0, "ranks": MULTI_RANKS}
    for quant in MULTI_ENGINES:
        equal = [bool(np.array_equal(r[f"engine/{quant}"],
                                     ref[f"rows/{quant}"])) for r in ranks]
        gaps = [float(np.abs(r[f"engine/{quant}"] - ref[f"engine/{quant}"])
                      .max()) for r in ranks]
        counts = [int(r[f"launches/{quant}"]) for r in ranks]
        gloo[f"engine_{quant}"] = {
            "bit_equal_to_rows_engines": equal,
            "max_abs_prob_diff_to_whole_batch": gaps,
            "launches_per_rank": counts}
        for r, n in enumerate(counts):
            launches[f"multi-GPU engine {quant}, gloo rank {r} of "
                     f"{MULTI_RANKS}"] = _only(quant, n)
        if not all(equal) or counts != [4] * MULTI_RANKS:
            raise AssertionError(f"gloo DP engine {quant}: bit-equal to the "
                                 f"rows' engines {equal}, launches {counts}")
    train_f = {k[12:]: v for k, v in ranks[0].items()
               if k.startswith("train/final/")}
    gloo["train_step_excess"] = _step_excess(train_f, ref["train"][1])
    gloo["yolo_step_gaps"] = yolo_gaps(ref["yolo"],
                                       unflat_yolo_run(ranks[0], "yolo/"))
    gloo["spatial_max_err"] = [float(r["spatial_err"]) for r in ranks]
    _, resumed, _ = elastic_leg(None, work / "elastic", restore=True)
    gloo["elastic"] = {"continuation_2": ranks[0]["elastic/cont"].tolist(),
                       "resumed_1": resumed}
    engine_text = []
    for q in MULTI_ENGINES:
        e = gloo[f"engine_{q}"]
        engine_text.append(f"{q} max |dprob| to the whole batch "
                           f"{max(e['max_abs_prob_diff_to_whole_batch']):.2e}"
                           f" launches {e['launches_per_rank']}")
    say(f"multi-GPU, {MULTI_RANKS} gloo ranks on the one card: engines "
        "bit-equal to the rows' engines, " + ", ".join(engine_text)
        + f"; classifier step at {gloo['train_step_excess']:.3f} of the gate"
        f"; yolov5s-mini step {_fmt(gloo['yolo_step_gaps'])}; halo conv "
        f"max |err| {gloo['spatial_max_err']}; elastic 2 -> 1 "
        f"{gloo['elastic']}; {gloo['seconds']:.1f} s [{card}]")
    if gloo["train_step_excess"] > 1.0:
        raise AssertionError("gloo DP classifier step off the gate")
    if any(g > t for g, t in zip(gloo["yolo_step_gaps"], YOLO_GATES["a"])):
        raise AssertionError("gloo DP yolov5s-mini step off YOLO_GATES")
    if max(gloo["spatial_max_err"]) > 1e-5:
        raise AssertionError("gloo halo conv differs from the plain conv")
    if not np.allclose(resumed, gloo["elastic"]["continuation_2"],
                       rtol=2e-3):
        raise AssertionError("elastic 2 -> 1 diverged")
    rec["gloo_ranks"] = gloo
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"phase 12: {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 13: tooling

# every block of the v5 zoo in one graph, at yolov5s widths (width 0.50,
# depth 0.33); tests/test_torch_v5_zoo.py runs it at width 0.125 on the CPU
ZOO_YAML = """
nc: 2
depth_multiple: 0.33
width_multiple: 0.50
anchors:
  - [10,13, 16,30, 33,23]
  - [30,61, 62,45, 59,119]
backbone:
  [[-1, 1, Focus, [64, 3]],
   [-1, 1, Conv, [128, 3, 2]],
   [-1, 3, BottleneckCSP, [128]],
   [-1, 1, GhostConv, [256, 3, 2]],
   [-1, 1, GhostBottleneck, [256, 3, 1]],
   [-1, 1, MixConv2d, [256, [1, 3], 1]],
   [-1, 1, CrossConv, [256, 3, 1, 1, 1.0, True]],
   [-1, 1, DWConv, [256, 3, 1]],
   [[-1, 4], 1, Sum, [True]],
   [-1, 1, Contract, [2]],
   [-1, 1, Expand, [2]],
   [-1, 1, GhostBottleneck, [512, 3, 2]],
   [-1, 1, SPP, [512, [5, 9, 13]]],
   [-1, 3, C3TR, [512, False]],
  ]
head:
  [[-1, 1, Conv, [256, 1, 1]],
   [-1, 1, nn.Upsample, [None, 2, 'nearest']],
   [[-1, 8], 1, Concat, [1]],
   [-1, 3, C3, [256, False]],
   [[17, 13], 1, Detect, [nc, anchors]],
  ]
"""
ZOO_SIZE = 416
ZOO_BATCH = 2
ZOO_TOL = 1e-4          # rtol, and atol of max |map|, as test_torch_detector
EXPORT_BATCHES = (1, 256)
HOST_CALLS = 100        # Engine.__call__ samples a turn


def reference_classifier_state(variables) -> dict:
    """The reference classifier's state dict of a JAX-layout tree (the
    port's names without ``head.``, a ``num_batches_tracked`` a
    BatchNorm), as its training code saves it."""
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    out = {}
    for key, val in torch_state_dict_from_variables(variables).items():
        key = key.removeprefix("head.")
        out[key] = val.float().clone()
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return out


def v5_reference_state(variables) -> dict:
    """The ultralytics state dict of a v5 JAX-layout tree: ``m{i}`` ->
    ``model.{i}``, ``m{i}_{j}`` -> ``model.{i}.{j}``, the Detect convs
    ``m{i}_m{j}`` -> ``model.{i}.m.{j}``, an inner ``m{j}`` -> ``m.{j}``."""
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    out = {}
    for key, val in torch_state_dict_from_variables(variables).items():
        top, *rest = key.split(".")
        head = re.sub(r"^m(\d+)_m(\d+)$", r"model.\1.m.\2", top)
        head = re.sub(r"^m(\d+)(?:_(\d+))?$",
                      lambda m: "model." + ".".join(g for g in m.groups()
                                                    if g), head)
        rest = [f"m.{p[1:]}" if re.fullmatch(r"m\d+", p) else p
                for p in rest]
        out[".".join([head] + rest)] = val.float().clone()
    return out


def _trees_equal(a, b) -> bool:
    from rtdm_tpu_torch.models.io import flatten_tree
    fa, fb = flatten_tree(a), flatten_tree(b)
    return fa.keys() == fb.keys() and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


def _host_median(fn, calls=HOST_CALLS) -> float:
    """Median host-clock ms of ``fn`` (which ends in a device-to-host
    copy), after 10 warm-up calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return _percentiles(ms)[0]


def phase_tooling(card, work, launches):
    """Phase 13: the tooling slice on the card (see the module docstring).
    Returns the records; ``launches`` gets each path's ACFF launches."""
    from rtdm_tpu_torch.cli import (build_engine, build_int8_engines,
                                    export_model, profile_model,
                                    pth_to_weights)
    from rtdm_tpu_torch.core.precision import tf32
    from rtdm_tpu_torch.data.example_set import write_engine_as_cfg
    from rtdm_tpu_torch.export.detector import (Detector,
                                                load_detection_model,
                                                load_detector)
    from rtdm_tpu_torch.export.engine import Engine, build_engine as build
    from rtdm_tpu_torch.export.serialize import load_exported
    from rtdm_tpu_torch.models.darknet import (Darknet, init_darknet,
                                               load_darknet_weights,
                                               save_darknet_weights)
    from rtdm_tpu_torch.models.io import (flatten_tree, load_variables,
                                          torch_state_dict_from_variables)
    from rtdm_tpu_torch.models.yolov5 import (YoloV5,
                                              load_yolov5_torch_checkpoint)
    from rtdm_tpu_torch.ops.yolo import decode_all
    t_phase = time.perf_counter()
    work = work / "tooling"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rec = {"card": card, "seconds": {}}
    with np.load(GOLDEN) as g:
        frames = g["frames_140"]
    with np.load(GOLDEN_DET) as g:
        det_frames = g["frames_416"]

    # (a) the classifier .pt path, in each precision
    t0 = time.perf_counter()
    sources = {"bf16": "squeeze-ernet_bf16", "fp32": "squeeze-ernet_bf16",
               "int8": "squeeze-ernet_int8"}
    for quant, name in sources.items():
        loaded = Engine.load(str(ENGINES / name))
        spec = dataclasses.replace(loaded.spec, quant=quant,
                                   batch_size=len(frames))
        pt = work / f"{name}.pt"
        torch.save(reference_classifier_state(loaded.variables), pt)
        from_pt = load_variables(str(pt))
        if not _trees_equal(from_pt, loaded.variables):
            raise AssertionError(f"{pt}: the .pt tree differs from the .npz")
        want = Engine(spec, loaded.variables, loaded.act_scales)(frames)
        eng = Engine(spec, from_pt, loaded.act_scales)
        _count_from_zero()
        got = eng(frames)
        _read_launches(f"tooling/.pt {quant} engine", launches,
                       _only(quant, 4))
        if not np.array_equal(got, want):
            raise AssertionError(f".pt {quant} engine: logits differ from "
                                 f"the .npz engine's by "
                                 f"{np.abs(got - want).max()}")
        say(f"tooling .pt: squeeze-ernet {quant} engine from the reference "
            f"state dict bit-equal to the .npz engine on the 10 golden "
            f"frames; 4 {quant} ACFF launches a forward")
    rec["seconds"]["classifier_pt"] = time.perf_counter() - t0

    # (b) darknet .weights: save, load, serve; pth_to_weights both ways
    t0 = time.perf_counter()
    v4 = ENGINES / "yolov4-tiny-mini_int8"
    ref = load_detector(str(v4))
    x16 = np.resize(det_frames, (ref.batch_size,) + det_frames.shape[1:])
    want = ref(x16)
    text = (v4 / "model.txt").read_text()
    weights = work / "v4.weights"
    save_darknet_weights(ref._variables, text, str(weights))
    init = init_darknet(Darknet(text))
    variables = load_darknet_weights(init, text, str(weights))
    if not _trees_equal(variables, ref._variables):
        raise AssertionError("yolov4-tiny .weights round trip differs")
    det = Detector(ref.model, variables, ref.spec, ref.batch_size,
                   act_scales=ref.act_scales)
    _count_from_zero()
    got = det(x16)
    _read_launches("tooling/.weights yolov4-tiny detector", launches,
                   _only("bf16", 0))
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the .weights detector's detections differ "
                             "from the .npz detector's")
    cfg4, npz4 = write_engine_as_cfg(v4, work)
    w2, back = work / "cli.weights", work / "cli_back.npz"
    _quiet(pth_to_weights.main, ["--cfg", cfg4, "--input", npz4,
                                 "--output", str(w2)])
    _quiet(pth_to_weights.main, ["--cfg", cfg4, "--input", str(w2),
                                 "--output", str(back)])
    if (w2.read_bytes() != weights.read_bytes()
            or not _trees_equal(load_variables(str(back)), ref._variables)):
        raise AssertionError("pth_to_weights round trip differs")
    say(f"tooling .weights: yolov4-tiny-mini .npz -> save_darknet_weights -> "
        f"load_darknet_weights -> Detector at batch {ref.batch_size}: "
        f"detections equal to the .npz detector's; pth_to_weights .npz -> "
        f".weights (byte-equal) -> .npz (equal tree)")
    rec["seconds"]["darknet_weights"] = time.perf_counter() - t0

    # (c) the v5 .pt: EMA preferred, and intersect from another nc
    t0 = time.perf_counter()
    v5 = ENGINES / "yolov5s-mini_int8"
    ref5 = load_detector(str(v5))
    want5 = ref5(x16)
    cfg5, npz5 = write_engine_as_cfg(v5, work)
    state = v5_reference_state(ref5._variables)
    pt5 = work / "v5.pt"
    torch.save({"model": {k: v + 1.0 for k, v in state.items()},
                "ema": state, "epoch": 3}, pt5)
    _, init5, _ = load_detection_model(cfg5, None, 416)
    got_tree = load_yolov5_torch_checkpoint(init5, str(pt5))
    if not _trees_equal(got_tree, ref5._variables):
        raise AssertionError("the v5 .pt import (EMA) differs from the .npz")
    det5 = Detector(ref5.model, got_tree, ref5.spec, ref5.batch_size,
                    act_scales=ref5.act_scales)
    got5 = det5(x16)
    if not all(np.array_equal(a, b) for a, b in zip(got5, want5)):
        raise AssertionError("the v5 .pt detector's detections differ from "
                             "the .npz detector's")
    detect = [k for k in state
              if re.fullmatch(r"model\.\d+\.m\.\d+\.(weight|bias)", k)]
    rng = np.random.default_rng(SEED)
    other_nc = dict(state)
    for k in detect:               # Detect at nc=80: 3 * 85 output channels
        shape = (255,) + tuple(state[k].shape[1:])
        other_nc[k] = torch.from_numpy(rng.normal(size=shape).astype(
            np.float32))
    pt80 = work / "v5_nc80.pt"
    torch.save({"model": other_nc}, pt80)
    try:
        load_yolov5_torch_checkpoint(init5, str(pt80))
        raise AssertionError("a shape-mismatched v5 .pt loaded without "
                             "intersect")
    except ValueError:
        pass
    partial = flatten_tree(load_yolov5_torch_checkpoint(init5, str(pt80),
                                                        intersect=True))
    full, fresh = flatten_tree(ref5._variables), flatten_tree(init5)
    heads = [k for k in partial if re.match(r"params/m\d+_m\d+/", k)]
    if not heads or any(
            not np.array_equal(v, (fresh if k in heads else full)[k])
            for k, v in partial.items()):
        raise AssertionError("intersect: the head or the backbone is wrong")
    say(f"tooling v5 .pt: yolov5s-mini from {{'model', 'ema'}} (EMA "
        f"preferred) equal to the .npz tree, detections equal to the .npz "
        f"detector's at batch {ref5.batch_size}; an nc=80 head refused "
        f"without intersect, with it {len(heads)} head leaves keep the init "
        f"and {len(partial) - len(heads)} load")
    rec["seconds"]["v5_pt"] = time.perf_counter() - t0

    # (d) the zoo at yolov5s widths, card against the CPU port, fp32
    t0 = time.perf_counter()
    net = YoloV5(ZOO_YAML)
    init_darknet(net, seed=SEED)
    net.eval()
    x = torch.from_numpy(np.random.default_rng(SEED).uniform(
        0, 1, (ZOO_BATCH, ZOO_SIZE, ZOO_SIZE, 3)).astype(np.float32))
    with torch.inference_mode():
        want = net(x)
        with tf32(False):
            got = net.cuda()(x.cuda())
    gaps = []
    for g, w in zip(got, want):
        g = g.cpu()
        gap = ((g - w).abs() - ZOO_TOL * w.abs()).max().item()
        gaps.append((g - w).abs().max().item() / w.abs().max().item())
        if gap > ZOO_TOL * w.abs().max().item():
            raise AssertionError(f"zoo: a map misses rtol {ZOO_TOL} / atol "
                                 f"{ZOO_TOL} of max |map|")
    blocks = sorted({e["module"] for e in net.plan})
    say(f"tooling zoo: {len(net.plan)} layers ({', '.join(blocks)}) at width "
        f"0.50, {ZOO_SIZE}^2, batch {ZOO_BATCH}: card against the CPU port "
        f"in fp32, TF32 off, max |d| / max |map| "
        f"{', '.join(f'{v:.3g}' for v in gaps)} (gate {ZOO_TOL} + rtol)")
    rec["zoo_max_rel"] = gaps
    rec["seconds"]["zoo"] = time.perf_counter() - t0

    # (e) profile_model on yolov5s-mini at 416, batch 1
    t0 = time.perf_counter()
    rows = profile_model.main(["--cfg", cfg5, "--img-size", "416",
                               "--batch", "1", "--iters", "10"])
    rec["profile_total_ms"] = sum(r["dt_ms"] for r in rows)
    rec["profile_gflops"] = sum(r["flops"] for r in rows) / 1e9
    say(f"tooling profile_model: yolov5s-mini 416^2 batch 1, {len(rows)} "
        f"layers, prefix differences sum to {rec['profile_total_ms']:.3f} "
        f"ms (CUDA events), {rec['profile_gflops']:.3f} GFLOPs [{card}]")
    rec["seconds"]["profile_model"] = time.perf_counter() - t0

    # (f) export_model: the three engines with --dynamic-batch, and a
    # detector; each loaded back and held to its eager forward
    t0 = time.perf_counter()
    bf16_dir = ENGINES / "squeeze-ernet_bf16"
    exports = {"bf16": ["--engine", str(bf16_dir)],
               "int8": ["--engine", str(ENGINES / "squeeze-ernet_int8")],
               "fp32": ["--model", "squeeze-ernet", "--weights",
                        str(bf16_dir / "params.npz")]}
    rec["export"] = {}
    for quant, flags in exports.items():
        out = work / f"squeeze-ernet_{quant}.pt2"
        _quiet(export_model.main, flags + ["--output", str(out),
                                           "--dynamic-batch"])
        eager = (build("squeeze-ernet",
                       load_variables(str(bf16_dir / "params.npz")), "fp32",
                       batch_size=1, verify=False) if quant == "fp32"
                 else Engine.load(flags[1]))
        call = load_exported(str(out))
        times = {}
        for b in EXPORT_BATCHES:
            u8 = torch.as_tensor(np.resize(frames, (b, 140, 140, 3)),
                                 device="cuda")
            with torch.no_grad(), tf32(False):
                want = eager._forward(u8)
                _count_from_zero()
                got = call(u8)
                torch.cuda.synchronize()
                _read_launches(f"tooling/exported {quant} program batch {b}",
                               launches, _only(quant, 4))
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"exported {quant} at batch {b}: differs from the "
                        f"eager engine by {(got - want).abs().max().item()}")
                times[b] = {"program": cuda_ms(lambda: call(u8), 20),
                            "eager": cuda_ms(lambda: eager._forward(u8), 20)}
        rec["export"][quant] = {"bytes": out.stat().st_size, "ms": times}
        say(f"tooling export: squeeze-ernet {quant} .pt2 "
            f"({out.stat().st_size} B, dynamic batch) bit-equal to the eager "
            f"engine at batch {' and '.join(map(str, EXPORT_BATCHES))}, 4 "
            f"{quant} launches a forward through the loaded program; ms a "
            f"forward (CUDA events) program / eager: " + ", ".join(
                f"b{b} {t['program']:.4f} / {t['eager']:.4f}"
                for b, t in times.items()) + f" [{card}]")
    out = work / "yolov4-tiny.pt2"
    _quiet(export_model.main, ["--cfg", cfg4, "--weights", npz4,
                               "--img-size", "416", "--dynamic-batch",
                               "--output", str(out)])
    model4, vars4, heads4 = load_detection_model(cfg4, npz4, 416)
    model4.load_state_dict(torch_state_dict_from_variables(vars4))
    model4 = model4.cuda().eval()
    call = load_exported(str(out))
    u8 = torch.as_tensor(x16, device="cuda")
    with torch.no_grad(), tf32(False):
        got = call(u8)
        want = decode_all(model4(u8.float() / 255.0), heads4, 416)
    det_gap = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"exported detector differs by {det_gap}")
    say(f"tooling export: yolov4-tiny-mini fp32 forward + decode_all at "
        f"416^2 exported with a dynamic batch, at batch {len(x16)} "
        f"bit-equal to the eager forward")
    rec["export"]["detector_max_abs"] = det_gap
    rec["seconds"]["export_model"] = time.perf_counter() - t0

    # (g) build_int8_engines on both detectors, calibrated on phase 10's
    # synthetic JPEGs, against build_engine on the same inputs
    t0 = time.perf_counter()
    calib = work.parent / "synth" / "data" / "images" / "val"
    wdir = work / "weights"
    cfgs = [write_engine_as_cfg(ENGINES / n, wdir)[0] for n in DETECTORS]
    save_darknet_weights(load_variables(str(wdir / f"{DETECTORS[0]}.npz")),
                         text, str(wdir / f"{DETECTORS[0]}.weights"))
    built, _ = _quiet(build_int8_engines.main,
                      ["--cfgs", *cfgs, "--weights-dir", str(wdir),
                       "--calib-dir", str(calib), "--output",
                       str(work / "int8")])
    for cfg, directory in zip(cfgs, built):
        stem = Path(cfg).stem
        w = str(wdir / f"{stem}{'.weights' if 'v4' in stem else '.npz'}")
        single = work / f"single_{stem}"
        _quiet(build_engine.main,
               ["--cfg", cfg, "--weights", w, "--quant", "int8",
                "--calib-dir", str(calib), "--calib-method", "entropy",
                "--batch-size", "16", "--output", str(single)])
        with np.load(Path(directory) / "act_scales.npz") as a, \
                np.load(single / "act_scales.npz") as b:
            same = sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files)
            n = len(a.files)
        if not same:
            raise AssertionError(f"{stem}: build_int8_engines' act_scales "
                                 f"differ from build_engine's")
        say(f"tooling build_int8_engines: {Path(directory).name} from {w} "
            f"calibrated (entropy) on {len(list(calib.glob('*.jpg')))} "
            f"synthetic JPEGs; its {n} act_scales equal build_engine's")
    rec["seconds"]["build_int8_engines"] = time.perf_counter() - t0

    # (h) the op's host cost: Engine.__call__ through rtdm::acff_infer
    # against the wrapper called directly (the forward before the op), in
    # turns
    from rtdm_tpu_torch.models.acff import ACFF
    from rtdm_tpu_torch.ops.acff import acff_infer

    def direct_forward(self, x):
        return acff_infer(self.kernel_input(x), *self.packed(),
                          act_scales=self.act_scales)

    loaded = Engine.load(str(bf16_dir))
    rec["host_ms"] = {}
    for b in EXPORT_BATCHES:
        eng = Engine(dataclasses.replace(loaded.spec, batch_size=b),
                     loaded.variables)
        x = np.resize(frames, (b, 140, 140, 3))
        turns = {"op": [], "direct": []}
        for turn in ("op", "direct", "direct", "op"):
            saved = ACFF.forward
            if turn == "direct":
                ACFF.forward = direct_forward
            try:
                turns[turn].append(_host_median(lambda: eng(x)))
            finally:
                ACFF.forward = saved
        rec["host_ms"][b] = turns
        say(f"tooling host: squeeze-ernet bf16 Engine.__call__ batch {b}, "
            f"median of {HOST_CALLS} (host clock), in turns: through "
            f"rtdm::acff_infer {turns['op'][0]:.4f} / {turns['op'][1]:.4f} "
            f"ms, the wrapper called directly {turns['direct'][0]:.4f} / "
            f"{turns['direct'][1]:.4f} ms [{card}]")
    rec["seconds"]["phase"] = time.perf_counter() - t_phase
    say("tooling times (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in rec["seconds"].items()))
    return rec


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

    # 2. build, and 11a: the host library beside it
    from rtdm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(phase_native_build)
        log = kernels.build("acff")
        say(f"build: acff in {time.perf_counter() - t0:.1f} s")
        native_build = native.result()
    say(f"build: native IO in {native_build['seconds']:.1f} s: "
        f"{native_build['command']}")
    say(f"build: native IO linked {native_build['libjpeg']}")
    for line in log.splitlines():
        if "ptxas" in line:
            say(f"  acff: {line.strip()}")
    counts = tensor_core_instructions(kernels.library_path("acff"))
    say(f"build: tensor-core instructions in the library (cuobjdump -sass): "
        f"{counts}")
    if not counts["HGMMA"] or not counts["HGMMA_TF32"]:
        raise AssertionError("the ACFF library lacks the bf16 or the TF32 "
                             "HGMMA (wgmma) instructions")

    # 3. kernel vs plain, at the main-path shapes and at fault 2's
    records = phase_kernels(("fp32", "bf16", "int8", "int8_branch"))
    fault2_rows, wide_records = phase_fault2()

    # 4. end to end
    from rtdm_tpu_torch.cli.aider_predict import load_image_rgb, preprocess
    with np.load(GOLDEN) as g:
        golden = dict(g)
    with np.load(GOLDEN_INT8) as g:
        golden_int8 = dict(g)
    examples = [ROOT / "docs" / "examples" / str(n) for n in golden["names"]]
    by_size = {}
    for s in (140, 240):
        by_size[s] = np.concatenate(
            [preprocess(load_image_rgb(str(p)), s) for p in examples])
        diff = np.abs(by_size[s].astype(int) - golden[f"frames_{s}"]).max()
        say(f"preprocess {s}: max |d| vs the golden's frames = {diff} "
            f"(PIL resampling of this machine)")
    frames = {m: by_size[240 if m == "ernet" else 140] for m in MODELS}
    launches, real = phase_end_to_end(frames, golden, golden_int8)
    calibration = phase_calibration(golden)

    # 5. timing
    engines = phase_timing(frames, card)
    # batch 1 is host-bound: its device busy share
    for key in (("bf16", 256), ("bf16", 1), ("int8", 256)):
        phase_profile(*engines[key], card)

    # 6. detection
    detection = phase_detection(card)

    # 7. the detection CLIs
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cli_records, cli_launches = phase_detect_cli(card, work)

    # 8. streaming, cascade and serving
    serving, serving_launches = phase_serving(card, work)

    # 9. training
    training, train_launches = phase_training(card, work, golden)

    # 10. detector training
    yolo_training, yolo_launches = phase_yolo_training(card, work)

    # 11. native host IO
    native_records, native_launches = phase_native_io(
        card, work, native_build, serving, yolo_training)

    # 12. multi-GPU
    multi_launches = {}
    multi = phase_multi_gpu(card, work, multi_launches)

    # 13. tooling
    tooling_launches = {}
    tooling = phase_tooling(card, work, tooling_launches)

    # 13. kernels line: one entry a kernel (the QDQ mode of the bf16 kernel
    # its own), summed over the ACFF blocks of one forward of its main path
    # (the Squeeze_ErNET engine of its precision), launches counted in that
    # forward; the bf16 kernel's entry also lists the veto's launches in
    # each yolo_detect --classify run
    main = {"bf16": "squeeze-ernet/bf16 engine dir",
            "fp32": "squeeze-ernet/fp32",
            "int8": "squeeze-ernet/int8 engine dir"}
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
            "launches_per_path": {
                **{p: n for p, n in launches.items()
                   if p.split("/")[1].startswith(quant)},
                **{p: n[quant] for p, n in cli_launches.items()
                   if n[quant]},
                **{p: n[quant] for p, n in serving_launches.items()
                   if n[quant]},
                **{p: n[quant] for p, n in train_launches.items()
                   if n[quant]},
                # the detector trainer launches no hand kernel: 0 on each
                **{p: n[quant] for p, n in yolo_launches.items()},
                **{p: n[quant] for p, n in native_launches.items()
                   if n[quant]},
                **{p: n[quant] for p, n in multi_launches.items()
                   if n[quant]},
                **{p: n[quant] for p, n in tooling_launches.items()
                   if n[quant]}},
            "per_shape": [r for r in records if r["quant"] == quant],
        })
        if quant in real:
            kernels_line[-1]["real_inputs"] = real[quant]
        if quant == "int8":
            kernels_line[-1]["calibration"] = calibration
            # both QDQ variants; the engines launch only the shared one
            kernels_line[-1]["variants"] = {v: {
                "name": KERNEL_NAME[v], "design": DESIGN[v],
                "launches": launches[path] if v == "int8" else 0,
                "ms": sum(r["ms"] for r in records
                          if r["model"] == "squeeze-ernet"
                          and r["quant"] == v),
                "per_shape": [{k: r[k] for k in (
                    "model", "block", "ms", "blocks_per_sm", "registers",
                    "act_scales")} for r in records if r["quant"] == v]}
                for v in ("int8", "int8_branch")}
    # the wide-C variant: no model reaches it, so no main path launches it;
    # summed over WIDE_SHAPES, checked at fault 2's shapes too
    for variant in ("bf16_wide", "int8_wide", "int8_branch_wide"):
        rows = [r for r in wide_records if r["quant"] == variant]
        ms = sum(r["ms"] for r in rows)
        bound_ms = sum(r["bound_ms"] for r in rows)
        kernels_line.append({
            "name": KERNEL_NAME[variant], "route": "cuda",
            "source": "rtdm_tpu_torch/csrc/acff.cu",
            "replaces": "rtdm_tpu/ops/acff_pallas.py:43",
            "launches": 0,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": ms, "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound_ms,
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None, "share_of_bound": bound_ms / ms,
            "sums_over": "the blocks (C, O, H=W) " + ", ".join(
                f"{tuple(r['x'][3:] + [r['o'], r['x'][1]])}" for r in rows)
                + f" at batch {BATCH}; no model's main path reaches it",
            "per_shape": rows,
            "fault2_checks": sum(1 for r in fault2_rows
                                 if variant in r["launches"])})
    sums = {q: sum(r["ms"] for r in records
                   if r["model"] == "squeeze-ernet" and r["quant"] == q)
            for q in DESIGN}
    say("kernel sums, Squeeze_ErNET blocks at batch 256: " + ", ".join(
        f"{q} {v:.4f} ms" for q, v in sums.items()) + f" [{card}]")
    say("detection: " + json.dumps(detection))
    say("detection CLIs: " + json.dumps(cli_records))
    say("streaming, cascade and serving: " + json.dumps(serving))
    say("ACFF launches on phase 8's paths: " + json.dumps(serving_launches))
    say("training: " + json.dumps(training, default=float))
    say("ACFF launches on phase 9's paths: " + json.dumps(train_launches))
    say("detector training: " + json.dumps(yolo_training, default=float))
    say("ACFF launches on phase 10's paths: " + json.dumps(yolo_launches))
    say("native host IO: " + json.dumps(native_records, default=float))
    say("ACFF launches on phase 11's paths: " + json.dumps(native_launches))
    say("multi-GPU: " + json.dumps(multi, default=float))
    say("ACFF launches on phase 12's paths: " + json.dumps(multi_launches))
    say("tooling: " + json.dumps(tooling, default=float))
    say("ACFF launches on phase 13's paths: "
        + json.dumps(tooling_launches))
    say(f"fault 2: {len(fault2_rows)} shapes x modes held to the plain "
        f"version")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(f"card: {card}")
    say(json.dumps({"kernels": kernels_line}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
