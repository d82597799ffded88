"""AIDER classifier training CLI.

Counterpart of ``rtdm_tpu/cli/aider_train.py``: the same knobs (model,
loss, optimizer, scheduler, grad accumulation, mixup/cutmix, early
stopping, resume, checkpoints) and ``--device`` (the card unless the CPU is
asked for). Each batch goes to the device as uint8 and is normalized
there; one train step (``train/trainer.py``) a batch, its metrics read one
step late so that the host does not wait for each step. Validation and the
test run the model at inference in the policy's dtype, every ACFF block
through the fp32 or bf16 kernel. The final weights are a JAX-layout
``.npz`` (``models/io.py``), which both packages' engines load.

Training is data-parallel over ``config.mesh()`` (``core/config.py``: the
process group that ``torchrun`` made, or this process alone), as the JAX
CLI trains over ``local_mesh()``: the batch is rounded up to a multiple of
the 'data' ranks times the microbatches, every rank's loader yields the
same global batches (one seed), and the trainer gives each rank its rows
(``train/trainer.py``). Rank 0 resolves the run directories and alone
writes the config, the logs, the checkpoints and the final weights.

Run: python -m rtdm_tpu_torch.cli.aider_train --model squeeze-ernet \\
         --root-dir data/AIDER --train-split .../aider_train.csv ...
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import time
from typing import Dict, List, Tuple

import torch

logger = logging.getLogger("rtdm_tpu_torch.train")


def parse_args(argv=None):
    from rtdm_tpu_torch.core.config import TrainingConfig

    p = argparse.ArgumentParser(description="Train AIDER classifiers")
    p.add_argument("--model", default="squeeze-ernet",
                   choices=["ernet", "squeeze-ernet", "squeeze-redconv"])
    p.add_argument("--loss", default="label_smoothing_ce",
                   choices=["crossentropy", "label_smoothing_ce", "focal"])
    p.add_argument("--optimizer", default="adamw",
                   choices=["adam", "adamw", "sgd"])
    p.add_argument("--scheduler", default="onecycle",
                   choices=["onecycle", "cosine", "reduce"])
    p.add_argument("--root-dir", default="data/AIDER")
    p.add_argument("--train-split", default="dataloaders/aider_train.csv")
    p.add_argument("--val-split", default="dataloaders/aider_val.csv")
    p.add_argument("--test-split", default="dataloaders/aider_test.csv")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--grad-accum-steps", type=int, default=2)
    p.add_argument("--warmup-ratio", type=float, default=0.1)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--no-early-stopping", action="store_true")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--mixup-alpha", type=float, default=0.2)
    p.add_argument("--cutmix-alpha", type=float, default=0.1)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--checkpoint-dir", default="saves")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--summary", action="store_true",
                   help="print the model summary (params + FLOPs) and exit")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--weights", default=None,
                   help="weights path: where the final model lands "
                        "(default <checkpoint-dir>/<model>.npz) and, with "
                        "--pretrained, the initial weights (.npz)")
    p.add_argument("--pretrained", action="store_true",
                   help="start from --weights instead of fresh init")
    p.add_argument("--min-lr", type=float, default=1e-6,
                   help="cosine/plateau lr floor")
    p.add_argument("--momentum", type=float, default=0.9,
                   help="SGD momentum")
    p.add_argument("--warmup-epochs", type=int, default=None,
                   help="warmup length in epochs; overrides --warmup-ratio")
    p.add_argument("--dropout", type=float, default=0.2,
                   help="model dropout probability")
    p.add_argument("--image-size", type=int, default=None,
                   help="input size override (default: 240 ernet, 140 the "
                        "squeeze variants)")
    p.add_argument("--checkpoint-freq", type=int, default=1, metavar="E",
                   help="save the resumable 'last' state every E epochs "
                        "(best is always saved on improvement)")
    p.add_argument("--save-best-only", action="store_true",
                   help="skip the periodic 'last' saves; keep best + the "
                        "final state")
    p.add_argument("--no-albumentations", action="store_true",
                   help="torchvision-style train augs instead of the "
                        "albumentations set")
    p.add_argument("--no-amp", action="store_true",
                   help="alias for --precision fp32")
    p.add_argument("--no-pin-memory", action="store_true",
                   help="accepted for parity: batches are copied from "
                        "pageable host memory either way")
    p.add_argument("--debug", action="store_true",
                   help="debug-level logging")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    a = p.parse_args(argv)
    if a.debug:
        logging.getLogger("rtdm_tpu_torch").setLevel(logging.DEBUG)
    cfg = TrainingConfig(
        model=a.model, loss=a.loss, optimizer=a.optimizer,
        scheduler=a.scheduler, root_dir=a.root_dir,
        train_split=a.train_split, val_split=a.val_split,
        test_split=a.test_split, batch_size=a.batch_size, epochs=a.epochs,
        lr=a.lr, weight_decay=a.weight_decay,
        label_smoothing=a.label_smoothing, grad_clip=a.grad_clip,
        grad_accum_steps=a.grad_accum_steps, warmup_ratio=a.warmup_ratio,
        precision="fp32" if a.no_amp else a.precision,
        patience=a.patience,
        early_stopping=not a.no_early_stopping, augment=not a.no_augment,
        mixup_alpha=a.mixup_alpha, cutmix_alpha=a.cutmix_alpha,
        num_workers=a.num_workers, checkpoint_dir=a.checkpoint_dir,
        log_dir=a.log_dir, resume=a.resume, seed=a.seed,
        pretrained=a.pretrained, min_lr=a.min_lr, momentum=a.momentum,
        dropout=a.dropout, checkpoint_freq=a.checkpoint_freq,
        save_best_only=a.save_best_only,
        use_albumentations=not a.no_albumentations, debug=a.debug,
        device=a.device)
    if a.weights is not None:
        cfg.weights = a.weights
    if a.image_size is not None:  # after __post_init__'s inference
        cfg.image_size = a.image_size
    if a.warmup_epochs is not None:
        cfg.warmup_epochs = a.warmup_epochs
        cfg.warmup_ratio = a.warmup_epochs / max(a.epochs, 1)
    return cfg


def current_lr(optimizer: torch.optim.Optimizer) -> float:
    """The learning rate of the optimizer's last update (of update 0
    before any)."""
    return float(optimizer.param_groups[0]["lr"])


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every group; a constant schedule keeps it."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def _load_pretrained(model, path: str) -> None:
    """Start ``model`` from the JAX-layout ``.npz`` or the reference's torch
    ``.pt``/``.pth`` at ``path`` (its BatchNorm statistics too where it has
    them)."""
    from rtdm_tpu_torch.models.io import (load_variables,
                                          torch_state_dict_from_variables)
    state = torch_state_dict_from_variables(load_variables(path))
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith(("running_mean", "running_var"))
                         for k in missing):
        raise KeyError(f"{path} does not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")


def train_model(config) -> Tuple[object, Dict[str, List[float]]]:
    from rtdm_tpu_torch.core.precision import policy_from_name
    from rtdm_tpu_torch.data.aider import (AiderDataset, BatchLoader,
                                           normalize_batch)
    from rtdm_tpu_torch.eval.classification import ClassificationMetrics
    from rtdm_tpu_torch.models import create_model
    from rtdm_tpu_torch.models.ernet import CLASS_NAMES
    from rtdm_tpu_torch.models.io import (save_variables,
                                          variables_from_torch_state_dict)
    from rtdm_tpu_torch.parallel.comms import broadcast_object
    from rtdm_tpu_torch.train.checkpoint import CheckpointManager
    from rtdm_tpu_torch.train.losses import make_classification_loss
    from rtdm_tpu_torch.train.schedules import (PlateauScaler,
                                                make_optimizer, make_schedule)
    from rtdm_tpu_torch.train.trainer import Trainer
    from rtdm_tpu_torch.utils.early_stopping import EarlyStopping
    from rtdm_tpu_torch.utils.experiment_log import ExperimentLogger
    from rtdm_tpu_torch.utils.meters import AverageMeter
    from rtdm_tpu_torch.utils.paths import increment_path

    mesh = config.mesh()
    device = mesh.device
    main = mesh.rank == 0
    policy = policy_from_name(config.precision)
    size = config.image_size

    # the batch tiles the 'data' ranks and the microbatch split
    bs = config.batch_size
    tile = mesh.shape["data"] * max(config.grad_accum_steps, 1)
    if bs % tile:
        bs = ((bs + tile - 1) // tile) * tile
        logger.info("batch_size rounded to %d (devices x accum)", bs)

    train_ds = AiderDataset(config.train_split, config.root_dir, size,
                            train=config.augment, seed=config.seed,
                            aug_style=("albumentations"
                                       if config.use_albumentations
                                       else "torchvision"))
    val_ds = AiderDataset(config.val_split, config.root_dir, size)
    test_ds = AiderDataset(config.test_split, config.root_dir, size)
    if len(train_ds) < bs:
        # drop_last would yield no batch at all
        raise SystemExit(
            f"train split has {len(train_ds)} images < one batch of {bs} "
            f"(batch_size after small-model doubling and accum tiling) — "
            f"lower --batch-size or add data")
    train_loader = BatchLoader(train_ds, bs, shuffle=True, drop_last=True,
                               num_workers=config.num_workers,
                               seed=config.seed)
    val_loader = BatchLoader(val_ds, bs, num_workers=config.num_workers)
    test_loader = BatchLoader(test_ds, bs, num_workers=config.num_workers)

    class_weights = (train_ds.class_weights()
                     if config.loss == "focal" else None)
    loss_fn = make_classification_loss(
        config.loss, label_smoothing=config.label_smoothing,
        focal_gamma=config.focal_gamma, class_weights=class_weights)

    total_steps = max(len(train_loader), 1) * config.epochs
    schedule = make_schedule(config.scheduler, config.lr, total_steps,
                             config.warmup_ratio, config.min_lr)
    tx = make_optimizer(config.optimizer, schedule, config.weight_decay,
                        config.momentum, config.grad_clip)

    model = create_model(config.model, device=device,
                         generator=torch.Generator().manual_seed(config.seed),
                         image_size=size, dropout_rate=config.dropout,
                         num_classes=config.num_classes)
    if config.pretrained and not config.resume:
        _load_pretrained(model, config.weights)
        logger.info("pretrained weights loaded from %s", config.weights)
    mixing = config.augment
    trainer = Trainer(model, tx, loss_fn, policy=policy,
                      grad_accum_steps=config.grad_accum_steps, mesh=mesh,
                      num_classes=config.num_classes,
                      mixup_alpha=config.mixup_alpha if mixing else 0.0,
                      cutmix_alpha=config.cutmix_alpha if mixing else 0.0,
                      sync_bn=config.sync_batchnorm)
    state = trainer.init_state()

    # collision-free run dirs, resolved by rank 0; resume lands in the
    # same dirs
    if main:
        weights_was_default = (config.weights == os.path.join(
            config.checkpoint_dir, f"{config.model}.npz"))
        config.checkpoint_dir = increment_path(config.checkpoint_dir,
                                               exist_ok=config.resume)
        config.log_dir = increment_path(config.log_dir,
                                        exist_ok=config.resume)
        if weights_was_default:
            config.weights = os.path.join(config.checkpoint_dir,
                                          f"{config.model}.npz")
        config.save()
    (config.checkpoint_dir, config.log_dir,
     config.weights) = broadcast_object(
        (config.checkpoint_dir, config.log_dir, config.weights), mesh)
    ckpt = CheckpointManager(config.checkpoint_dir, mesh)
    history: Dict[str, List[float]] = {k: [] for k in
                                       ("train_loss", "train_acc", "val_loss",
                                        "val_acc", "val_f1", "lr")}
    start_epoch = 0
    if config.resume and ckpt.exists("last"):
        state, meta = ckpt.restore("last", state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        history = meta.get("history", history)
        logger.info("resumed from epoch %d", start_epoch)

    def put_batch(images, labels):
        x = normalize_batch(torch.from_numpy(images).to(device))
        return x, torch.from_numpy(labels).long().to(device)

    explog = (ExperimentLogger(config.log_dir, run_name=config.model,
                               config=dataclasses.asdict(config))
              if main else None)
    stopper = EarlyStopping(config.patience)
    plateau = (PlateauScaler(patience=max(config.epochs // 3, 1),
                             base_lr=config.lr, min_lr=config.min_lr)
               if config.scheduler == "reduce" else None)
    step_seed = config.seed + 1
    best_val = float("inf")
    if start_epoch and history.get("val_loss"):
        # a resumed run competes against the best before the interruption
        best_val = float(min(history["val_loss"]))
        stopper.best_loss = best_val

    def run_eval(loader):
        metrics = ClassificationMetrics(config.num_classes, CLASS_NAMES)
        for images, labels, valid in loader:
            x, y = put_batch(images, labels)
            out = trainer.eval_step(state, x, y, valid)
            metrics.update(out["confusion"].cpu().numpy(),
                           float(out.get("loss_sum", 0.0)),
                           int(out["count"]))
        return metrics

    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        loss_m, acc_m = AverageMeter("loss"), AverageMeter("acc")
        # step N-1's metrics are read while step N runs on the device
        pending = None

        def drain(p):
            pm, pn = p
            loss = float(pm["loss"])
            if not math.isfinite(loss):
                raise SystemExit(f"non-finite train loss {loss} "
                                 f"(epoch {epoch + 1}) — aborting")
            loss_m.update(loss, pn)
            acc_m.update(float(pm["accuracy"]), pn)

        for images, labels, _ in train_loader:
            x, y = put_batch(images, labels)
            state, m = trainer.train_step(state, x, y, step_seed)
            if pending is not None:
                drain(pending)
            pending = (m, len(labels))
        if pending is not None:
            drain(pending)

        val = run_eval(val_loader)
        lr = current_lr(state.optimizer)
        history["train_loss"].append(loss_m.avg)
        history["train_acc"].append(acc_m.avg)
        history["val_loss"].append(val.loss)
        history["val_acc"].append(val.accuracy)
        history["val_f1"].append(val.f1("weighted"))
        history["lr"].append(lr)
        if explog:
            explog.log_scalars(epoch, {"train_loss": loss_m.avg,
                                       "train_acc": acc_m.avg,
                                       "val_loss": val.loss,
                                       "val_acc": val.accuracy,
                                       "val_f1": val.f1("weighted"),
                                       "lr": lr})
        logger.info(
            "epoch %d/%d: train loss %.4f acc %.4f | val loss %.4f acc %.4f "
            "f1 %.4f | lr %.2e | %.1fs", epoch + 1, config.epochs,
            loss_m.avg, acc_m.avg, val.loss, val.accuracy,
            val.f1("weighted"), lr, time.time() - t0)

        if plateau is not None:
            _set_lr(state.optimizer, config.lr * plateau.update(val.loss))

        meta = {"epoch": epoch, "history": history,
                "config": dataclasses.asdict(config),
                "val_loss": val.loss, "val_acc": val.accuracy}
        # 'last' every --checkpoint-freq epochs and on the final epoch;
        # --save-best-only skips the periodic saves
        final_epoch = epoch == config.epochs - 1
        if final_epoch or (not config.save_best_only
                           and (epoch + 1)
                           % max(config.checkpoint_freq, 1) == 0):
            ckpt.save("last", state, meta)
        stopper(val.loss)
        if val.loss < best_val:
            best_val = val.loss
            ckpt.save("best", state, meta)
        if config.early_stopping and stopper.should_stop:
            logger.info("early stopping at epoch %d", epoch + 1)
            break

    if ckpt.exists("best"):
        state, _ = ckpt.restore("best", state)
    test = run_eval(test_loader)
    logger.info("test:\n%s", test.report())

    if not main:
        return state, history
    wpath = save_variables(config.weights, variables_from_torch_state_dict(
        state.model.state_dict()))
    logger.info("final weights saved to %s", wpath)
    explog.log_artifact(wpath)
    explog.close()

    try:
        from rtdm_tpu_torch.utils.plots import plot_training_curves
        plot_training_curves(history, config.log_dir, config.model)
    except Exception as e:  # plotting must never fail a run
        logger.warning("plotting failed: %s", e)
    return state, history


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    import sys
    args = sys.argv[1:] if argv is None else argv
    if "--summary" in args:
        from rtdm_tpu_torch.utils.summary import summarize_classifier
        name = (args[args.index("--model") + 1]
                if "--model" in args else "squeeze-ernet")
        print(summarize_classifier(name))
        return None
    config = parse_args(argv)
    train_model(config)  # saves config.json into the resolved run dir


if __name__ == "__main__":
    main()
