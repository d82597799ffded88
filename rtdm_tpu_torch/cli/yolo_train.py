"""YOLO detector training CLI.

Counterpart of ``rtdm_tpu/cli/yolo_train.py`` (``--device``, the card
unless the CPU is asked for), data-parallel over the ranks of the process
group that ``torchrun`` made (one rank without a launcher: JAX's
``local_mesh()``): the batch rounds down to a multiple of the ranks, every
rank's loader yields the same global batches, the step and the eval give
each rank its rows, and rank 0 writes the run's files. A darknet ``.cfg``
or v5 ``.yaml`` model (``export/detector.py::load_detection_model``:
``.npz``, ``.pt`` or darknet ``.weights``),
the training sample of ``data/odder.py`` (mosaic, the affine warp, HSV,
flip; rect buckets; image weights), the v3 or v5 loss
(``train/yolo_loss.py``), either optimizer family
(``train/schedules.py::make_yolo_optimizer``), EMA, BN burn-in, prebias,
multi-scale, autoanchor, per-epoch mAP (``eval/map.py``), the fitness
weights, ``last.npz`` / ``best.npz`` / ``backup{N}.npz``, ``results.txt``,
the resumable ``last_state`` and the strip at the end; ``--evolve`` runs
the reference's hyperparameter evolution (``train/evolve.py``).

The train step (``make_train_step``) is the JAX ``make_step``: the loader
batch is split into ``accumulate`` microbatches, each a forward in
training mode (batch-statistic BatchNorm whose running statistics chain
from microbatch to microbatch, or stay as they are during BN burn-in;
dropout from a generator seeded by (seed, step, microbatch)) and a
backward; the summed gradients are divided by ``accumulate``, clipped and
applied, and the EMA follows. In bf16 the conv kernels and biases are cast
inside the forward (``functional_call``) while BatchNorm keeps its fp32
parameters, as the JAX layers cast their kernels to the input's dtype.
Multi-scale resizes the batch on the device with ``jax.image.resize``'s
antialiased bilinear as the jitted step computes it
(``export/detector.py::resize_bilinear``, ``fused``). The loss
components of step N - 1 are read while step N runs, and a non-finite one
ends training one step late, as in the JAX loop.

Run: python -m rtdm_tpu_torch.cli.yolo_train --cfg model.cfg \\
         --data data/set.data --weights start.npz --epochs 100
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger("rtdm_tpu_torch.yolo_train")

# fitness weights, per family:
# darknet: over [P, R, mAP@0.5, F1] (yolov3/train.py:343-345)
FITNESS_W = (0.0, 0.01, 0.99, 0.0)
# v5: over [P, R, mAP@0.5, mAP@0.5:0.95] (yolov5/utils/metrics.py:12-15)
FITNESS_W_V5 = (0.0, 0.0, 0.1, 0.9)
_INV255 = np.float32(1.0) / np.float32(255.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train YOLO detectors")
    p.add_argument("--cfg", required=True)
    p.add_argument("--data", help="dataset .data file (required unless "
                   "--summary)")
    p.add_argument("--weights", help="initial weights (.npz)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--lr0", type=float, default=0.001)
    p.add_argument("--lrf", type=float, default=None,
                   help="final lr = lr0 * 10**lrf (cosine; default -4 for "
                        "darknet cfgs; v5 yamls default to the hyp file's "
                        "one_cycle factor lrf)")
    p.add_argument("--linear-lr", action="store_true",
                   help="linear lr decay instead of the cosine (v5 yamls)")
    p.add_argument("--momentum", type=float, default=0.637)
    p.add_argument("--weight-decay", type=float, default=0.000084)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--burn-in", type=int, default=200,
                   help="linear LR warm-up steps")
    p.add_argument("--iou-t", type=float, default=0.3)
    p.add_argument("--fl-gamma", type=float, default=None,
                   help="focal gamma (default: 1.5 darknet, 0.0 v5)")
    p.add_argument("--giou-gain", type=float, default=1.0)
    p.add_argument("--cls-gain", type=float, default=37.4)
    p.add_argument("--obj-gain", type=float, default=64.3)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--cache-images", action="store_true",
                   help="keep decoded frames in RAM across epochs")
    p.add_argument("--single-cls", action="store_true",
                   help="train as a single-class detector: every label "
                        "maps to class 0 (darknet cfgs must already be "
                        "1-class)")
    p.add_argument("--noautoanchor", action="store_true",
                   help="skip the train-start BPR anchor check (v5 yaml "
                        "models only)")
    p.add_argument("--precision", default="fp32", choices=["bf16", "fp32"])
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--output", default="runs/train")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--eval-every", type=int, default=1,
                   help="mAP-eval every N epochs (0 = only after the "
                   "final epoch)")
    p.add_argument("--nominal-batch", type=int, default=64,
                   help="accumulate grads to this effective batch")
    p.add_argument("--evolve", type=int, default=0, metavar="N",
                   help="genetic hyperparameter evolution over N cycles")
    p.add_argument("--hyp", help="hyp yaml overriding loss/aug knobs "
                   "(yolov5 data/hyp.scratch.yaml format)")
    p.add_argument("--multi-scale", action="store_true",
                   help="resize batches to 67-150%% of --img-size on the "
                        "device")
    p.add_argument("--rect", action="store_true",
                   help="rectangular training: AR-sorted stride-multiple "
                        "batch buckets, mosaic disabled, fixed sample "
                        "order")
    p.add_argument("--prebias", type=int, default=0, metavar="E",
                   help="train only detection-head biases for the first E "
                        "epochs")
    p.add_argument("--image-weights", action="store_true",
                   help="class-weighted image resampling per epoch")
    p.add_argument("--ema", action="store_true",
                   help="keep an EMA of the weights (ModelEMA)")
    p.add_argument("--train-list-override",
                   help="use this image-list txt for training instead of "
                        "the .data file's train entry")
    p.add_argument("--resume", action="store_true",
                   help="resume from <output>/last_state (params, BN "
                        "buffers, optimizer state, EMA, epoch, "
                        "best_fitness)")
    p.add_argument("--no-strip", action="store_true",
                   help="keep the optimizer-state checkpoint after a "
                        "completed run")
    p.add_argument("--no-plots", action="store_true",
                   help="skip the plots (label distribution, train-batch "
                        "mosaics, results curves; matplotlib)")
    p.add_argument("--ckpt-every", type=int, default=1, metavar="E",
                   help="write the resumable full-state checkpoint every E "
                        "epochs")
    p.add_argument("--nosave", action="store_true",
                   help="only save checkpoints on the final epoch")
    p.add_argument("--notest", action="store_true",
                   help="only run the mAP eval on the final epoch (alias "
                        "for --eval-every 0)")
    p.add_argument("--label-smoothing", type=float, default=None,
                   metavar="EPS",
                   help="v5 cls-BCE label smoothing epsilon; overrides the "
                        "hyp yaml value")
    p.add_argument("--save-period", type=int, default=0, metavar="N",
                   help="also keep a backup{N}.npz weight snapshot every N "
                        "epochs (0 disables)")
    p.add_argument("--summary", action="store_true",
                   help="print the per-layer model summary and exit")
    p.add_argument("--bn-burn-in", type=int, default=None, metavar="N",
                   help="freeze BN running stats for the first N batches "
                        "(default 200 darknet, 0 for v5 yamls)")
    p.add_argument("--adam", action="store_true",
                   help="alias for --optimizer adam")
    p.add_argument("--accumulate", type=int, default=None, metavar="N",
                   help="explicit grad-accumulation count, overriding the "
                        "--nominal-batch derivation")
    p.add_argument("--workers", type=int, default=None,
                   help="alias for --num-workers")
    p.add_argument("--project", default=None,
                   help="with --name: run dir = project/name, "
                        "collision-incremented; overrides --output")
    p.add_argument("--name", default="exp",
                   help="run name under --project")
    p.add_argument("--exist-ok", action="store_true",
                   help="reuse an existing project/name dir instead of "
                        "incrementing")
    p.add_argument("--sync-bn", action="store_true",
                   help="accepted for parity: BatchNorm's statistics are "
                        "already the global batch's over the data mesh")
    p.add_argument("--device", default="cuda",
                   help="torch device (the card unless 'cpu' is asked for)")
    args = p.parse_args(argv)
    if args.adam:
        args.optimizer = "adam"
    if args.workers is not None:
        args.num_workers = args.workers
    if args.project is not None:
        args.output = os.path.join(args.project, args.name)
    return args


# ---------------------------------------------------------------------------
# the train and eval steps


def input_of(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Frames (uint8, or fp32 after a resize) -> the network's input,
    ``images.astype(dtype) / 255`` as the compiled JAX step rounds it (a
    multiply by fp32(1/255))."""
    x = images.to(dtype).float() * torch.tensor(_INV255,
                                                device=images.device)
    return x.to(dtype)


def conv_param_names(model: torch.nn.Module) -> set:
    """The parameters that a reduced-precision forward casts: the kernels
    and biases of the convs (the JAX layers cast them to the input's
    dtype; BatchNorm and the parametric activations compute in fp32)."""
    from rtdm_tpu_torch.models.layers import Conv, DepthwiseConv, Dense
    names = set()
    for mname, mod in model.named_modules():
        if isinstance(mod, (Conv, DepthwiseConv, Dense)):
            for pname, _ in mod.named_parameters(recurse=False):
                names.add(f"{mname}.{pname}" if mname else pname)
    return names


def head_bias_names(model: torch.nn.Module) -> list:
    """The detection-output convs' biases (the prebias epochs' only
    trained parameters)."""
    from rtdm_tpu_torch.models.darknet import parse_darknet_cfg
    from rtdm_tpu_torch.models.yolov5 import YoloV5
    if isinstance(model, YoloV5):
        tops = {n.split(".")[0] for n, _ in model.named_parameters()}
        heads = {t for t in tops
                 if "_m" in t and t.split("_")[0][1:].isdigit()}
    else:
        defs = parse_darknet_cfg(model.cfg_text)[1:]
        heads = {f"l{i - 1}_conv" for i, d in enumerate(defs)
                 if d["type"] == "yolo"}
    return [n for n, _ in model.named_parameters()
            if n.endswith(".bias") and n.split(".")[0] in heads]


def make_train_step(model, heads, loss_fn, hyp, dtype: torch.dtype,
                    accumulate: int, img_size: int, ema=None, mesh=None):
    """``step(opt, images, labels, nlab, it, seed, train_size=None,
    update_bn=True) -> (loss, comps, grad_norm)`` (device tensors: loss and
    the (box, obj, cls) components over the microbatches, each divided by
    ``accumulate``; the gradients' global norm before the clip).

    ``images`` is the loader's uint8 NHWC batch on the model's device,
    ``labels`` (B, M, 5) class + pixel cxcywh and ``nlab`` (B,);
    ``train_size`` a square size (a batch at ``img_size`` is resized to it
    and its labels scaled) or None for a rect batch (no resize; the loss
    takes max(h, w)); ``update_bn=False`` keeps the running statistics
    (BN burn-in); ``opt`` a ``YoloOptimizer``; ``it`` the step, which seeds
    the dropout masks and sets the EMA's decay.

    Under ``mesh`` (``core/mesh.py``) every rank is handed the global batch
    and the step is data-parallel as JAX's GSPMD step is: each global
    microbatch is cut to the rank's rows, BatchNorm takes the global
    batch's statistics and the dropout masks are the rows' slices of the
    global mask (``models/layers.py::set_mesh``), the loss is the rank's
    share of the global one (``train/yolo_loss.py``), and the gradients are
    summed over the ranks before the division, the clip and the update;
    the loss and components returned are the global ones."""
    from torch.func import functional_call

    from rtdm_tpu_torch.core.mesh import data_sharding
    from rtdm_tpu_torch.core.precision import tf32
    from rtdm_tpu_torch.export.detector import resize_bilinear
    from rtdm_tpu_torch.models.layers import (set_bn_update,
                                              set_dropout_generator, set_mesh)
    from rtdm_tpu_torch.parallel.comms import all_reduce_grads, psum_along
    from rtdm_tpu_torch.train.ema import ema_update
    from rtdm_tpu_torch.train.trainer import _draw_generators
    cast = conv_param_names(model) if dtype != torch.float32 else set()
    shard = data_sharding(mesh) if mesh is not None else None
    if mesh is not None:
        set_mesh(model, mesh)

    def forward(x):
        if not cast:
            return model(x)
        params = {n: (p.to(dtype) if n in cast else p)
                  for n, p in model.named_parameters()}
        return functional_call(model, params, (x,))

    def step(opt, images, labels, nlab, it: int, seed: int,
             train_size=None, update_bn: bool = True):
        chunks = list(zip(images.chunk(accumulate), labels.chunk(accumulate),
                          nlab.chunk(accumulate)))
        if shard is not None:
            chunks = [tuple(shard(t) for t in c) for c in chunks]
            images, labels = (torch.cat([c[0] for c in chunks]),
                              torch.cat([c[1] for c in chunks]))
        if train_size is None:
            loss_size = max(images.shape[1], images.shape[2])
        else:
            loss_size = train_size
            if train_size != images.shape[1]:
                images = resize_bilinear(images.float(),
                                         (train_size, train_size), True)
                labels = labels.clone()
                labels[..., 1:5] *= train_size / img_size
        model.train()
        for p in model.parameters():
            p.grad = None
        loss_sum = torch.zeros((), device=images.device)
        comp_sum = torch.zeros(3, device=images.device)
        with tf32(dtype != torch.float32):
            set_bn_update(model, update_bn)
            try:
                for i, (im, lb, nl) in enumerate(zip(
                        images.chunk(accumulate), labels.chunk(accumulate),
                        [c[2] for c in chunks])):
                    set_dropout_generator(model, _draw_generators(
                        seed, it, i, images.device)[1])
                    loss, comps = loss_fn(forward(input_of(im, dtype)),
                                          heads, lb, nl, loss_size, hyp,
                                          mesh=mesh)
                    loss.backward()
                    loss_sum = loss_sum + loss.detach()
                    comp_sum = comp_sum + torch.stack(
                        [comps["box"], comps["obj"], comps["cls"]]).detach()
            finally:
                set_bn_update(model, True)
                set_dropout_generator(model, None)
            if mesh is not None:
                all_reduce_grads(list(model.parameters()), mesh)
                loss_sum, comp_sum = psum_along((loss_sum, comp_sum), mesh)
            if accumulate > 1:
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accumulate)
            grad_norm = opt.step()
        if ema is not None:
            ema_update(ema, model, it)
        return loss_sum / accumulate, comp_sum / accumulate, grad_norm

    return step


class EvalStep:
    """The JAX ``eval_step``: the model at inference in the run's dtype
    (a copy whose conv parameters are cast, BatchNorm in fp32), decode, and
    ``batched_nms(pred, 0.001, 0.6, 300, 512, multi_label=True)``. ``load``
    copies a state dict (the live weights or the EMA) in. Under ``mesh``
    each rank runs its rows of the batch and ``(det, count)`` is
    all-gathered."""

    def __init__(self, model, heads, dtype: torch.dtype, img_size: int,
                 mesh=None):
        self.mesh = mesh
        self.model = copy.deepcopy(model).eval().requires_grad_(False)
        cast = conv_param_names(self.model)
        for name, p in self.model.named_parameters():
            if name in cast:
                p.data = p.data.to(dtype)
        self.heads, self.dtype, self.img_size = heads, dtype, img_size

    def load(self, state_dict) -> None:
        self.model.load_state_dict(state_dict)

    @torch.no_grad()
    def __call__(self, images: torch.Tensor):
        from rtdm_tpu_torch.core.mesh import data_sharding
        from rtdm_tpu_torch.core.precision import tf32
        from rtdm_tpu_torch.ops.nms import batched_nms
        from rtdm_tpu_torch.ops.yolo import decode_all
        from rtdm_tpu_torch.parallel.comms import all_gather_along
        if self.mesh is not None:
            images = data_sharding(self.mesh)(images)
        with tf32(self.dtype != torch.float32):
            raw = self.model(input_of(images, self.dtype))
        with tf32(False):
            pred = decode_all(raw, self.heads, self.img_size)
            det, count = batched_nms(pred, 0.001, 0.6, 300, 512,
                                     multi_label=True)
        if self.mesh is None:
            return det, count
        return (all_gather_along(det, self.mesh),
                all_gather_along(count, self.mesh))


def build_loss(args, hyp_file, heads, nc: int, is_v5: bool):
    """(loss function, its hyperparameters) of the run."""
    from rtdm_tpu_torch.train.yolo_loss import (YoloHyp, YoloHypV5,
                                                scale_v5_gains, yolo_loss,
                                                yolo_loss_v5)
    if is_v5:
        hyp = YoloHypV5(
            box=hyp_file.get("box", 0.05),
            cls=hyp_file.get("cls", 0.5),
            cls_pw=hyp_file.get("cls_pw", 1.0),
            obj=hyp_file.get("obj", 1.0),
            obj_pw=hyp_file.get("obj_pw", 1.0),
            anchor_t=hyp_file.get("anchor_t", 4.0),
            label_smoothing=(args.label_smoothing
                             if args.label_smoothing is not None
                             else hyp_file.get("label_smoothing", 0.0)),
            fl_gamma=(args.fl_gamma if args.fl_gamma is not None
                      else hyp_file.get("fl_gamma", 0.0)))
        return yolo_loss_v5, scale_v5_gains(hyp, nl=len(heads), nc=nc,
                                            img_size=args.img_size)
    hyp = YoloHyp(giou=args.giou_gain, cls=args.cls_gain,
                  obj=args.obj_gain, iou_t=args.iou_t,
                  cls_pw=float(hyp_file.get("cls_pw", 1.0)),
                  obj_pw=float(hyp_file.get("obj_pw", 1.0)),
                  fl_gamma=args.fl_gamma if args.fl_gamma is not None
                  else 1.5)
    return yolo_loss, hyp


def build_optimizer(args, model, is_v5: bool, hyp_file,
                    steps_per_epoch: int, total_steps: int):
    from rtdm_tpu_torch.train.schedules import make_yolo_optimizer
    return make_yolo_optimizer(
        model, is_v5, args.optimizer, args.lr0, args.momentum,
        args.weight_decay, total_steps, lrf=args.lrf, burn_in=args.burn_in,
        linear_lr=args.linear_lr, hyp=hyp_file,
        steps_per_epoch=steps_per_epoch)


def accumulation(batch_size: int, nominal_batch: int, accumulate=None,
                 ranks: int = 1) -> int:
    """The microbatch count: --accumulate, or the nominal batch over the
    batch, clamped to the largest count not above it that splits the
    loader batch into microbatches of whole rows on each of ``ranks``
    (a divisor of ``batch_size / ranks``). JAX's GSPMD step reshards an
    uneven microbatch and clamps to a divisor of the batch alone; the
    counts differ only where that one leaves a microbatch that does not
    divide over the ranks."""
    a = (max(accumulate, 1) if accumulate is not None
         else max(round(nominal_batch / batch_size), 1))
    return max(d for d in range(1, a + 1)
               if batch_size % (d * ranks) == 0)


def multi_scale_sizes(img_size: int, gs: int = 32) -> list:
    """67-150% of img_size in stride steps (yolov3/train.py:269-275)."""
    return sorted({max(round(img_size * s / gs) * gs, gs)
                   for s in (0.67, 0.83, 1.0, 1.17, 1.5)})


def load_model(cfg: str, weights, img_size: int, num_classes, device):
    """(model on ``device`` with the weights loaded, heads); the weights
    are ``.npz``, ``.pt``/``.pth`` or darknet ``.weights``
    (``export/detector.py::load_detection_model``). A v5 start loads
    shape-tolerantly (``intersect``), so a checkpoint of other classes
    seeds the backbone."""
    from rtdm_tpu_torch.export.detector import (load_detection_model,
                                                model_heads)
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    v5 = cfg.endswith((".yaml", ".yml"))
    model, variables, _ = load_detection_model(
        cfg, weights, img_size, num_classes, intersect=v5 and bool(weights))
    model.load_state_dict(torch_state_dict_from_variables(variables))
    return model.to(device), tuple(model_heads(model))


# ---------------------------------------------------------------------------
# training


def train(args):
    from rtdm_tpu_torch.core.mesh import data_parallel_mesh
    from rtdm_tpu_torch.data.odder import (DetectionBatchLoader,
                                           DetectionDataset, load_data_spec)
    from rtdm_tpu_torch.eval.map import DetectionEvaluator
    from rtdm_tpu_torch.models.io import (save_variables,
                                          variables_from_torch_state_dict)
    from rtdm_tpu_torch.ops.nms import xywh_to_xyxy
    from rtdm_tpu_torch.parallel.comms import broadcast_object
    from rtdm_tpu_torch.train.checkpoint import CheckpointManager
    from rtdm_tpu_torch.train.ema import ema_init
    from rtdm_tpu_torch.train.schedules import make_prebias_optimizer
    from rtdm_tpu_torch.utils import yaml_io
    from rtdm_tpu_torch.utils.experiment_log import ExperimentLogger
    from rtdm_tpu_torch.utils.paths import increment_path

    mesh = data_parallel_mesh(args.device)
    device, main = mesh.device, mesh.rank == 0
    if args.notest:
        args.eval_every = 0
    # the run directory first (rank 0's): anything written before it is
    # resolved would make it look taken
    if main:
        args.output = increment_path(args.output,
                                     exist_ok=args.resume or args.exist_ok)
    args.output = broadcast_object(args.output, mesh)
    if args.sync_bn:
        logger.info("--sync-bn: the batch statistics are already the global "
                    "batch's over the %d-rank data mesh",
                    mesh.shape["data"])
    # the batch rounds down to a multiple of the ranks
    n_dev = mesh.shape["data"]
    bs = max(args.batch_size // n_dev, 1) * n_dev
    accumulate = accumulation(bs, args.nominal_batch, args.accumulate,
                              n_dev)
    one_device = accumulation(bs, args.nominal_batch, args.accumulate)
    if accumulate != one_device:
        logger.info("accumulate %d, not %d: each microbatch of the batch "
                    "of %d must divide over the %d ranks", accumulate,
                    one_device, bs, n_dev)

    dcfg = load_data_spec(args.data)
    base = str(dcfg["base"])
    train_list = args.train_list_override or dcfg["train"]
    hyp_file = yaml_io.load(args.hyp) if args.hyp else {}
    aug_keys = ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate",
                "scale", "shear", "fliplr", "mosaic", "mosaic9", "mixup",
                "cutout")
    aug_hyp = {k: hyp_file[k] for k in aug_keys if k in hyp_file}
    nc_data = int(dcfg.get("classes", 2))
    nc = 1 if args.single_cls else nc_data
    if args.rect and args.image_weights:
        logger.warning("--image-weights disables --rect "
                       "(yolov5/utils/datasets.py:358)")
        args.rect = False
    if args.rect and args.multi_scale:
        raise SystemExit("--rect and --multi-scale are mutually exclusive: "
                         "multi-scale resizes square batches on device; "
                         "rect batches already vary their shape per bucket")
    train_ds = DetectionDataset(train_list, args.img_size, base_dir=base,
                                train=not args.no_augment, aug_hyp=aug_hyp,
                                seed=args.seed, num_classes=nc_data,
                                single_cls=args.single_cls,
                                cache_images=args.cache_images,
                                rect=args.rect, batch_size=bs, rect_pad=0.0)
    if len(train_ds) < bs:
        logger.warning("train set (%d) smaller than batch (%d): indices "
                       "will cycle", len(train_ds), bs)
    val_ds = DetectionDataset(dcfg["valid"], args.img_size, base_dir=base,
                              num_classes=nc_data,
                              single_cls=args.single_cls,
                              cache_images=args.cache_images)
    img_w = None
    if args.image_weights:
        counts = np.concatenate([lab[:, 0] for lab in train_ds.labels
                                 if len(lab)] or [np.zeros(1)])
        cls_w = np.bincount(counts.astype(int), minlength=nc).astype(float)
        cls_w = (1.0 / np.maximum(cls_w, 1)) ** 0.5
        img_w = train_ds.image_weights(cls_w)
    train_loader = DetectionBatchLoader(train_ds, bs, shuffle=not args.rect,
                                        drop_last=True,
                                        num_workers=args.num_workers,
                                        seed=args.seed, image_weights=img_w)
    val_loader = DetectionBatchLoader(val_ds, bs,
                                      num_workers=args.num_workers)

    is_v5 = args.cfg.endswith((".yaml", ".yml"))
    model, heads = load_model(args.cfg, args.weights, args.img_size,
                              nc if is_v5 else None, device)
    if heads[0].num_classes != nc:
        raise SystemExit(
            f"model has {heads[0].num_classes} classes but the run wants "
            f"{nc} (data cfg classes={nc_data}"
            + (", --single-cls" if args.single_cls else "")
            + "); use a matching cfg/yaml")
    loss_fn, hyp = build_loss(args, hyp_file, heads, nc, is_v5)

    if is_v5 and not args.noautoanchor:
        # the train-start anchor check (yolov5/train.py:213-216): evolve a
        # set when the BPR is under 0.98, and write the model yaml with it
        from rtdm_tpu_torch.models.yolov5 import parse_v5_yaml
        from rtdm_tpu_torch.train.autoanchor import (check_anchor_order,
                                                     check_anchors)
        apx = np.stack([h.anchors_px for h in heads])
        new_a, bpr, evolved = check_anchors(train_ds, apx, args.img_size,
                                            thr=float(hyp.anchor_t))
        if evolved:
            new_a = check_anchor_order(new_a.reshape(apx.shape))
            for h, a in zip(heads, new_a):
                h.anchors_px = np.asarray(a, np.float32)
            d = parse_v5_yaml(model.yaml_text, nc)
            d["anchors"] = [[float(x) for x in lv.reshape(-1)]
                            for lv in new_a]
            anchor_yaml = os.path.join(args.output, "model-autoanchor.yaml")
            if main:
                os.makedirs(args.output, exist_ok=True)
                yaml_io.dump(d, anchor_yaml)
            logger.info("autoanchor: BPR %.3f < 0.98 -> evolved anchors; "
                        "updated yaml saved to %s", bpr, anchor_yaml)
        else:
            logger.info("autoanchor: BPR %.3f, current anchors fit", bpr)

    steps_per_epoch = max(len(train_loader), 1)
    total_steps = steps_per_epoch * args.epochs
    opt = build_optimizer(args, model, is_v5, hyp_file, steps_per_epoch,
                          total_steps)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    ema = ema_init(model) if args.ema else None
    step_fn = make_train_step(model, heads, loss_fn, hyp, dtype, accumulate,
                              args.img_size, ema, mesh)
    eval_step = EvalStep(model, heads, dtype, args.img_size, mesh)
    n_burn = (args.bn_burn_in if args.bn_burn_in is not None
              else (0 if is_v5 else 200))
    sizes = multi_scale_sizes(args.img_size) if args.multi_scale else None
    size_rng = np.random.default_rng(args.seed + 7)
    prebias_names = head_bias_names(model) if args.prebias > 0 else []

    # rank 0 writes the run's files
    plots = main and not args.no_plots
    if main:
        os.makedirs(args.output, exist_ok=True)
    explog = (ExperimentLogger(args.output, run_name="yolo",
                               config=vars(args)) if main else None)
    results_path = os.path.join(args.output, "results.txt")
    names = list(dcfg.get("names") or [])
    if plots:
        from rtdm_tpu_torch.utils.plots import plot_label_distribution
        rows = np.concatenate([lab for lab in train_ds.labels if len(lab)]
                              or [np.zeros((0, 5), np.float32)])
        plot_label_distribution(rows, os.path.join(args.output,
                                                   "labels.png"), names)
    ckpt_mgr = CheckpointManager(args.output, mesh)
    best_fitness, start_epoch, it, history = -1.0, 0, 0, []
    if args.resume:
        if not ckpt_mgr.exists("last_state"):
            raise SystemExit(f"--resume: no checkpoint at "
                             f"{os.path.join(args.output, 'last_state')}")
        state, meta = ckpt_mgr.restore_tree("last_state", device)
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optimizer"])
        if ema is not None:
            for k, v in state["ema"].items():
                ema[k].copy_(v)
        start_epoch = int(meta.get("epoch", -1)) + 1
        it = int(meta.get("it", 0))
        best_fitness = float(meta.get("best_fitness", -1.0))
        history = list(meta.get("history", []))
        logger.info("resumed at epoch %d (it %d, best_fitness %.4f)",
                    start_epoch, it, best_fitness)

    def weights_now():
        sd = ema if ema is not None else model.state_dict()
        return variables_from_torch_state_dict(sd)

    aborted = False
    res, last_res, ep_loss = None, None, np.zeros(3)
    prebias_opt = None
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        ep_loss = np.zeros(3)
        nb = 0
        pending = None      # step N-1's components, read while N runs
        in_prebias = args.prebias > 0 and epoch < args.prebias
        if in_prebias and prebias_opt is None:
            prebias_opt = make_prebias_optimizer(model, prebias_names)
        for batch, _valid in train_loader:
            if plots and epoch == start_epoch and nb < 3:
                from rtdm_tpu_torch.utils.plots import plot_detection_batch
                plot_detection_batch(
                    batch["image"], batch["labels"], batch["num_labels"],
                    os.path.join(args.output, f"train_batch{nb}.jpg"),
                    names)
            images = torch.from_numpy(batch["image"]).to(device)
            labels = torch.from_numpy(batch["labels"]).to(device)
            nlab = torch.from_numpy(batch["num_labels"]).to(device)
            if args.rect:
                train_size = None
            elif sizes is not None and not in_prebias:
                # the prebias step stays at img_size (yolo_train.py:604)
                train_size = int(size_rng.choice(sizes))
            else:
                train_size = args.img_size
            _, comps, _ = step_fn(prebias_opt if in_prebias else opt,
                                  images, labels, nlab, it, args.seed,
                                  train_size=train_size,
                                  update_bn=in_prebias or it >= n_burn)
            if pending is not None:
                comps_np = pending.cpu().numpy()
                if not np.isfinite(comps_np).all():
                    logger.error("WARNING: non-finite loss %s at step %d — "
                                 "ending training", comps_np.tolist(), it - 1)
                    aborted = True
                    break
                ep_loss += comps_np
            pending = comps
            nb += 1
            it += 1
        if pending is not None and not aborted:
            comps_np = pending.cpu().numpy()
            if not np.isfinite(comps_np).all():
                logger.error("WARNING: non-finite loss %s at final step %d",
                             comps_np.tolist(), it - 1)
                aborted = True
            else:
                ep_loss += comps_np
        if aborted:
            break
        ep_loss /= max(nb, 1)

        line = (f"epoch {epoch + 1}/{args.epochs} "
                f"box {ep_loss[0]:.4f} obj {ep_loss[1]:.4f} "
                f"cls {ep_loss[2]:.4f} {time.time() - t0:.1f}s")
        res = None
        if ((args.eval_every > 0 and (epoch + 1) % args.eval_every == 0)
                or epoch == args.epochs - 1):
            eval_step.load(ema if ema is not None else model.state_dict())
            ev = DetectionEvaluator(
                nc, np.linspace(0.5, 0.95, 10) if is_v5
                else np.array([0.5]), family="v5" if is_v5 else "v3")
            for batch, valid in val_loader:
                det, count = eval_step(
                    torch.from_numpy(batch["image"]).to(device))
                det, count = det.cpu().numpy(), count.cpu().numpy()
                for i in range(valid):
                    n = int(count[i])
                    nl = int(batch["num_labels"][i])
                    lab = batch["labels"][i][:nl]
                    gt = xywh_to_xyxy(torch.from_numpy(lab[:, 1:5])).numpy()
                    ev.add_image(det[i][:n], gt, lab[:, 0].astype(np.int32))
            res = ev.results()
            f1 = (2 * res["mp"] * res["mr"]
                  / max(res["mp"] + res["mr"], 1e-9))
            fitness = (float(np.dot(FITNESS_W_V5,
                                    [res["mp"], res["mr"], res["map50"],
                                     res["map"]]))
                       if is_v5 else
                       float(np.dot(FITNESS_W,
                                    [res["mp"], res["mr"], res["map50"],
                                     f1])))
            line += (f" | P {res['mp']:.3f} R {res['mr']:.3f} "
                     f"mAP@0.5 {res['map50']:.3f}")
            if main and (not args.nosave or epoch == args.epochs - 1):
                var_now = weights_now()
                save_variables(os.path.join(args.output, "last.npz"),
                               var_now)
                if fitness > best_fitness:
                    save_variables(os.path.join(args.output, "best.npz"),
                                   var_now)
            best_fitness = max(best_fitness, fitness)
        logger.info(line)
        if res is not None:
            last_res = res
        scalars = {"box": float(ep_loss[0]), "obj": float(ep_loss[1]),
                   "cls": float(ep_loss[2])}
        if res is not None:
            scalars.update({"precision": res["mp"], "recall": res["mr"],
                            "map50": res["map50"]})
            if is_v5:
                scalars["map"] = res["map"]
        if main:
            explog.log_scalars(epoch, scalars)
            with open(results_path, "a") as f:
                f.write(line + "\n")
        history.append({"loss": ep_loss.tolist(),
                        "map50": None if res is None else res["map50"],
                        "map": None if (res is None or not is_v5)
                        else res["map"]})
        if main and args.save_period > 0 and \
                (epoch + 1) % args.save_period == 0:
            save_variables(os.path.join(args.output,
                                        f"backup{epoch + 1}.npz"),
                           weights_now())
        if ((epoch + 1) % max(args.ckpt_every, 1) == 0 and not args.nosave) \
                or epoch == args.epochs - 1:
            ckpt_mgr.save_tree("last_state",
                               {"model": model.state_dict(),
                                "optimizer": opt.state_dict(),
                                "ema": ema or {}},
                               metadata={"epoch": epoch, "it": it,
                                         "best_fitness": best_fitness,
                                         "history": history})
    if not aborted and not args.no_strip:
        # the strip at the end (yolov5/utils/general.py:587): a completed
        # run keeps only the deployable weights. Every rank calls remove
        # (it waits for rank 0's delete), whatever it saw: rank 0 may have
        # deleted the file before another rank looked
        stripped = ckpt_mgr.exists("last_state")
        ckpt_mgr.remove("last_state")
        if stripped:
            logger.info("optimizer state stripped; best.npz/last.npz keep "
                        "the deployable weights")
    if plots and os.path.exists(results_path):
        from rtdm_tpu_torch.utils.plots import plot_detector_results
        plot_detector_results(results_path,
                              os.path.join(args.output, "results.png"))
    if explog:
        explog.close()
    return {"model": model, "heads": heads, "ema": ema,
            "history": history, "best_fitness": best_fitness,
            "last_eval": last_res, "aborted": aborted,
            "last_loss": [float(v) for v in ep_loss[:3]],
            "accumulate": accumulate}


# ---------------------------------------------------------------------------
# hyperparameter evolution

# gene -> flag routing: these genes are trainer flags; every other gene
# rides the per-generation hyp yaml (--hyp)
V3_GENE_FLAGS = {"giou": "giou_gain", "cls": "cls_gain", "obj": "obj_gain",
                 "iou_t": "iou_t", "lr0": "lr0", "lrf": "lrf",
                 "momentum": "momentum", "weight_decay": "weight_decay",
                 "fl_gamma": "fl_gamma"}
V5_GENE_FLAGS = {"lr0": "lr0", "momentum": "momentum",
                 "weight_decay": "weight_decay"}

# seed values for genes not given by --hyp or a flag: v3 =
# yolov3/train.py:27-44's hyp dict; v5 = data/hyp.scratch.yaml
V3_GENE_DEFAULTS = {
    "giou": 1.0, "cls": 37.4, "cls_pw": 1.0, "obj": 64.3, "obj_pw": 1.0,
    "iou_t": 0.3, "lr0": 0.001, "lrf": -4.0, "momentum": 0.637,
    "weight_decay": 0.000084, "fl_gamma": 1.5, "hsv_h": 0.0138,
    "hsv_s": 0.678, "hsv_v": 0.36, "degrees": 0.0, "translate": 0.0,
    "scale": 0.0, "shear": 0.0,
}
V5_GENE_DEFAULTS = {
    "lr0": 0.01, "lrf": 0.2, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
    "iou_t": 0.2, "anchor_t": 4.0, "fl_gamma": 0.0, "hsv_h": 0.015,
    "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0, "translate": 0.1,
    "scale": 0.5, "shear": 0.0, "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.0,
}


def evolve(args):
    """The reference's hyperparameter evolution (yolov3/train.py:444-491,
    yolov5/train.py:583-612): generation 0 trains the seed hyp; each later
    one mutates a parent drawn from evolve.txt's top rows
    (``train/evolve.py``), trains it with ``--nosave``, and appends its
    final-epoch P, R, mAP@0.5, mAP@0.5:0.95 (v5) or F1 (v3) and train
    losses. The best row goes to hyp_evolved.yaml. Returns (best hyp, its
    fitness)."""
    from rtdm_tpu_torch.train.evolve import (FITNESS_W_V3, FITNESS_W_V5,
                                             V3_EVOLVE_META, V5_EVOLVE_META,
                                             EvolveLog)
    from rtdm_tpu_torch.train.evolve import fitness as fitness_of
    from rtdm_tpu_torch.core.mesh import data_parallel_mesh
    from rtdm_tpu_torch.train.evolve import mutate, select_parent
    from rtdm_tpu_torch.utils import yaml_io

    if data_parallel_mesh(args.device).size > 1:
        raise SystemExit("--evolve runs as one process: its generations "
                         "write evolve.txt and their hyp files in turn")
    rng = np.random.default_rng(args.seed)
    is_v5 = args.cfg.endswith((".yaml", ".yml"))
    meta = V5_EVOLVE_META if is_v5 else V3_EVOLVE_META
    w_fit = FITNESS_W_V5 if is_v5 else FITNESS_W_V3
    mut_p = 0.8 if is_v5 else 0.9
    flags = V5_GENE_FLAGS if is_v5 else V3_GENE_FLAGS
    defaults = V5_GENE_DEFAULTS if is_v5 else V3_GENE_DEFAULTS
    hyp_file = yaml_io.load(args.hyp) if args.hyp else {}

    def seed_of(k):
        if k in hyp_file:
            return float(hyp_file[k])
        if k in flags and getattr(args, flags[k]) is not None:
            return float(getattr(args, flags[k]))
        return float(defaults[k])

    base = {k: seed_of(k) for k in meta}
    os.makedirs(args.output, exist_ok=True)
    log = EvolveLog(os.path.join(args.output, "evolve.txt"), meta, w_fit)
    for g in range(args.evolve):
        rows = log.load()
        if rows is None:
            hyp = dict(base)
        else:
            parent = select_parent(rows, rng, w_fit=w_fit)
            hyp = mutate(log.genes_of(parent), meta, rng, mp=mut_p)
        trial = argparse.Namespace(**vars(args))
        trial.evolve = 0
        trial.nosave = True
        trial.output = os.path.join(args.output, f"gen{g}")
        for k, flag in flags.items():
            setattr(trial, flag, hyp[k])
        trial_hyp = dict(hyp_file)
        trial_hyp.update({k: hyp[k] for k in meta if k not in flags})
        hyp_path = os.path.join(args.output, f"gen{g}-hyp.yaml")
        yaml_io.dump(trial_hyp, hyp_path, sort_keys=False)
        trial.hyp = hyp_path
        if is_v5:
            # the yaml's genes rule: a flag would override them
            trial.fl_gamma = None
            trial.lrf = None
        result = train(trial)
        ev = result.get("last_eval") or {}
        p_, r_ = float(ev.get("mp", 0.0)), float(ev.get("mr", 0.0))
        map50 = float(ev.get("map50", 0.0))
        col4 = (float(ev.get("map", 0.0)) if is_v5
                else 2 * p_ * r_ / max(p_ + r_, 1e-9))
        losses = result.get("last_loss", [0.0, 0.0, 0.0])
        log.append(hyp, [p_, r_, map50, col4] + list(losses))
        logger.info("evolve gen %d: fitness %.5f", g, float(
            fitness_of(np.array([[p_, r_, map50, col4]]), w_fit)[0]))
    yaml_out = os.path.join(args.output, "hyp_evolved.yaml")
    log.save_yaml(yaml_out)
    best_hyp = log.best() or dict(base)
    rows = log.load()
    best_fit = (float(fitness_of(rows, w_fit).max())
                if rows is not None else -1.0)
    logger.info("evolved hyp -> %s (fitness %.5f): %s", yaml_out, best_fit,
                best_hyp)
    if not args.no_plots and os.path.exists(log.path):
        from rtdm_tpu_torch.utils.plots import plot_evolution_results
        plot_evolution_results(log.path,
                               os.path.join(args.output, "evolve.png"),
                               keys=list(meta), w_fit=w_fit)
    return best_hyp, best_fit


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    args = parse_args(argv)
    from rtdm_tpu_torch.utils.checks import check_img_size
    args.img_size = check_img_size(args.img_size)
    if args.summary:
        from rtdm_tpu_torch.utils.summary import summarize_detector
        print(summarize_detector(args.cfg, args.img_size))
        return None
    if not args.data:
        raise SystemExit("--data is required (unless --summary)")
    if args.evolve:
        return evolve(args)
    return train(args)


if __name__ == "__main__":
    main()
