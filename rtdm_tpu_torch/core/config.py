"""Typed training configuration.

Counterpart of ``rtdm_tpu/core/config.py::TrainingConfig``: the classifier
trainer's knobs, the image size inferred from the model name (ErNET 240,
the squeeze variants 140), the batch doubled once for the squeeze
variants, and a JSON dump that ``load`` reads back without doubling again.
``device`` is where training runs: the card unless the caller asks for the
CPU. ``mesh()`` is the mesh a run trains over (``core/mesh.py``): with
``mesh_shape`` ``()`` a 1-D 'data' mesh over every rank of the process
group (one rank without a launcher), else ``create_mesh(mesh_shape)``
over the axes 'data', 'spatial', 'model'. ``sync_batchnorm`` False keeps
each rank's BatchNorm statistics its own (the DDP form); True takes the
global batch's, as JAX's GSPMD step does. Both keep the JAX file format,
so that a JAX run's ``config.json`` loads here and the port's loads there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class TrainingConfig:
    # Model
    model: str = "squeeze-ernet"
    pretrained: bool = False
    resume: bool = False
    weights: Optional[str] = None
    loss: str = "label_smoothing_ce"
    num_classes: int = 5

    # Data
    root_dir: str = "data/AIDER"
    train_split: str = "dataloaders/aider_train.csv"
    val_split: str = "dataloaders/aider_val.csv"
    test_split: str = "dataloaders/aider_test.csv"
    image_size: Optional[int] = None  # None -> inferred from the model
    augment: bool = True
    use_albumentations: bool = True   # False -> torchvision-style augs
    num_workers: int = 8

    # Optimisation
    batch_size: int = 32
    epochs: int = 200
    optimizer: str = "adamw"
    lr: float = 3e-4
    min_lr: float = 1e-6
    weight_decay: float = 0.01
    momentum: float = 0.9
    label_smoothing: float = 0.1
    focal_gamma: float = 2.0
    grad_clip: float = 1.0
    grad_accum_steps: int = 2
    scheduler: str = "onecycle"
    warmup_epochs: int = 5
    warmup_ratio: float = 0.1
    mixup_alpha: float = 0.2
    cutmix_alpha: float = 0.1
    dropout: float = 0.2

    # Precision, device and mesh
    precision: str = "bf16"          # 'bf16' | 'fp32'
    mesh_shape: Tuple[int, ...] = ()
    sync_batchnorm: bool = True
    device: str = "cuda"

    # Checkpointing
    checkpoint_dir: str = "saves"
    checkpoint_freq: int = 1
    save_best_only: bool = True

    # Early stopping
    early_stopping: bool = True
    patience: int = 20

    # Misc
    seed: int = 42
    debug: bool = False
    log_dir: str = "logs"

    # the squeeze batch doubling happens exactly once, so that replace()
    # and load() do not double again
    batch_doubled: bool = False

    def __post_init__(self):
        if self.image_size is None:
            self.image_size = 240 if self.model.lower() == "ernet" else 140
        if self.model.lower() != "ernet" and not self.batch_doubled:
            self.batch_size *= 2
            self.batch_doubled = True
        if self.weights is None:
            self.weights = os.path.join(self.checkpoint_dir,
                                        f"{self.model}.npz")

    def mesh(self):
        """Join the launcher's process group (a no-op without one) and
        build the run's mesh on ``device``."""
        from rtdm_tpu_torch.core.mesh import (create_mesh, distributed_init,
                                              local_mesh)
        distributed_init(device=self.device)
        if not self.mesh_shape:
            return local_mesh(device=self.device)
        names = ("data", "spatial", "model")
        if len(self.mesh_shape) > len(names):
            raise ValueError(f"mesh_shape {self.mesh_shape}: at most "
                             f"{len(names)} axes ({names})")
        return create_mesh(self.mesh_shape, names[:len(self.mesh_shape)],
                           self.device)

    def save(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.log_dir, "config.json")
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=4)
        return path

    @classmethod
    def load(cls, path: str) -> "TrainingConfig":
        """Read a saved config as it was written (no second doubling);
        keys this class does not know are dropped, missing ones take their
        defaults."""
        with open(path) as f:
            raw = json.load(f)
        cfg = cls.__new__(cls)
        for f_ in dataclasses.fields(cls):
            setattr(cfg, f_.name, raw.get(f_.name, f_.default))
        if isinstance(cfg.mesh_shape, list):
            cfg.mesh_shape = tuple(cfg.mesh_shape)
        return cfg
