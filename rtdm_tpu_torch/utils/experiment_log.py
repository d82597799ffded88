"""Experiment logging: TensorBoard scalars and a W&B-compatible run log.

Counterpart of ``rtdm_tpu/utils/experiment_log.py``: scalars go to
TensorBoard through ``torch.utils.tensorboard`` where it imports, to W&B
where the package exists and is asked for, and always to a local JSONL run
log (config, scalars, artifact paths) in ``log_dir``.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional


class ExperimentLogger:
    def __init__(self, log_dir: str, run_name: Optional[str] = None,
                 use_tensorboard: bool = True, use_wandb: bool = False,
                 config: Optional[Dict[str, Any]] = None,
                 run_id: Optional[str] = None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.run_id = run_id or uuid.uuid4().hex[:8]
        self.run_name = run_name or f"run-{self.run_id}"

        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, "tb",
                                                      self.run_name))
            except Exception:
                self._tb = None

        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project="rtdm_tpu_torch",
                                         name=self.run_name,
                                         id=self.run_id, resume="allow",
                                         config=config or {})
            except Exception as e:  # noqa: BLE001 — wandb.init raises
                # CommError/UsageError on offline/unauthenticated hosts,
                # not just ImportError; all of them fall back to JSONL
                import logging
                logging.getLogger(__name__).info(
                    "wandb unavailable (%s); logging to JSONL", e)
                self._wandb = None

        self._jsonl_path = os.path.join(log_dir, f"{self.run_name}.jsonl")
        if config:
            self._write({"event": "config", "run_id": self.run_id,
                         "config": config})

    def _write(self, record: Dict[str, Any]) -> None:
        record.setdefault("t", time.time())
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    prefix: str = "") -> None:
        tagged = {f"{prefix}{k}": float(v) for k, v in scalars.items()}
        if self._tb is not None:
            for k, v in tagged.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(tagged, step=step)
        self._write({"event": "scalars", "step": step, **tagged})

    def log_artifact(self, path: str, kind: str = "model") -> None:
        if self._wandb is not None:
            import wandb
            art = wandb.Artifact(os.path.basename(path), type=kind)
            art.add_file(path) if os.path.isfile(path) else \
                art.add_dir(path)
            self._wandb.log_artifact(art)
        self._write({"event": "artifact", "kind": kind,
                     "path": os.path.abspath(path)})

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
