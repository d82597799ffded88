"""Checkpoint and resume.

Counterpart of ``rtdm_tpu/train/checkpoint.py`` with ``torch.save`` in
place of Orbax: a tag (``last``, ``best``) is ``<tag>.pt``, the step count
and the model's and optimizer's state dicts, beside the same
``<tag>.meta.json`` (epoch, best metrics, history, config) the JAX manager
writes. ``save_tree`` / ``restore_tree`` store any tree of state dicts the
same way (the detector trainer's full state: parameters and BatchNorm
buffers, optimizer, EMA); ``remove`` deletes a tag and its metadata (the
strip at the end of a run). Loads use ``torch.load(weights_only=True)``
from the directory given and nowhere else.

Under a data-parallel ``mesh`` the state is replicated, so rank 0 writes
and every rank waits for it (a barrier) before going on; every rank reads.
A state saved at one world size restores at any other (the elastic
resume): nothing in it depends on the world size.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rtdm_tpu_torch.parallel.comms import barrier
from rtdm_tpu_torch.train.trainer import TrainState


class CheckpointManager:
    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        os.makedirs(self.directory, exist_ok=True)

    def _written(self) -> None:
        """Every rank waits here until rank 0's write is done."""
        if self.mesh is not None:
            barrier(self.mesh)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{tag}.pt")

    def save(self, tag: str, state: TrainState,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        path = self._path(tag)
        if self.writes:
            torch.save({"step": state.step,
                        "model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict()},
                       path + ".tmp")
            os.replace(path + ".tmp", path)
            if metadata is not None:
                with open(self._meta_path(tag), "w") as f:
                    json.dump(_jsonify(metadata), f, indent=2)
        self._written()
        return path

    def restore(self, tag: str, state: TrainState
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Load ``tag`` into ``state``'s model and optimizer (in place, on
        their device) and its step; returns the state and the metadata."""
        device = next(state.model.parameters()).device
        saved = torch.load(self._path(tag), map_location=device,
                           weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        state.weights_changed()
        meta_path = os.path.join(self.directory, f"{tag}.meta.json")
        metadata = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        return state, metadata

    def save_tree(self, tag: str, tree: Dict[str, Any],
                  metadata: Optional[Dict[str, Any]] = None) -> str:
        """Store ``tree`` (state dicts, tensors, numbers) under ``tag``."""
        path = self._path(tag)
        if self.writes:
            torch.save(tree, path + ".tmp")
            os.replace(path + ".tmp", path)
            if metadata is not None:
                with open(self._meta_path(tag), "w") as f:
                    json.dump(_jsonify(metadata), f, indent=2)
        self._written()
        return path

    def restore_tree(self, tag: str, device="cpu"
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tree, metadata) stored under ``tag``, tensors on ``device``."""
        tree = torch.load(self._path(tag), map_location=device,
                          weights_only=True)
        metadata = {}
        if os.path.exists(self._meta_path(tag)):
            with open(self._meta_path(tag)) as f:
                metadata = json.load(f)
        return tree, metadata

    def remove(self, tag: str) -> None:
        if self.writes:
            for path in (self._path(tag), self._meta_path(tag)):
                if os.path.exists(path):
                    os.remove(path)
        self._written()

    def _meta_path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{tag}.meta.json")

    def exists(self, tag: str) -> bool:
        return os.path.isfile(self._path(tag))


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, (np.generic,)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj
