"""Read PyTorch checkpoints of the reference's classifiers into the port.

Counterpart of ``rtdm_tpu/models/torch_import.py``. It reads the
classifier family's state dicts (``squeeze-ernet-state_dict.pt`` and the
like), the trainer's rich checkpoints (``{'model_state_dict': ...}``) and
full-module pickles of training-code classes that are not installed
(``Squeeze97.pt``, ``ernet.pt``).

The result is a JAX-layout variables tree of float32 arrays, the form every
port entry point loads (``models/io.py::torch_state_dict_from_variables``
turns it into the port's state dict), equal array for array to the JAX
package's import of the same file:

- Conv2d weight (O, I/g, kH, kW) -> HWIO (kH, kW, I/g, O); a depthwise
  (C, 1, kH, kW) -> (kH, kW, 1, C);
- Linear weight (out, in) -> (in, out);
- BatchNorm weight/bias -> params scale/bias, running_mean/running_var ->
  batch_stats mean/var; num_batches_tracked is dropped;
- ``conv2`` and ``fc`` move under ``head`` (``models/ernet.py::_ErnetHead``).

The fc rows need no permutation: the models flatten in torch's
channel-major order.
"""

from __future__ import annotations

import pickle
import types
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


class _StubUnpickler(pickle.Unpickler):
    """An unpickler that stands in an empty ``nn.Module`` subclass for every
    class whose module cannot be imported (a full-module pickle names the
    training code's classes, ``model.ernet.ErNET``). Unpickling a module
    only needs the class to exist: its state goes straight into
    ``__dict__``, so ``state_dict()`` works on the stand-in."""

    def find_class(self, module: str, name: str):
        try:
            return super().find_class(module, name)
        except (ModuleNotFoundError, AttributeError):
            return type(name, (nn.Module,), {"__module__": module})


# torch.load's ``pickle_module``: it subclasses ``Unpickler`` for the zip
# format and calls ``load`` for the legacy one
_STUB_PICKLE = types.ModuleType("rtdm_stub_pickle")
_STUB_PICKLE.Unpickler = _StubUnpickler
_STUB_PICKLE.load = lambda f, **kw: _StubUnpickler(f, **kw).load()


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pt`` file as {key: ndarray} on the CPU: a state dict, a
    ``{'model_state_dict': ...}`` or ``{'model': ...}`` checkpoint (but not
    a state dict whose 'model' key is itself a tensor), or a pickled
    module. Unpickling runs code: open only files of trusted origin."""
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_STUB_PICKLE)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if (isinstance(obj, dict) and "model" in obj
            and not hasattr(obj["model"], "detach")):
        obj = obj["model"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, Mapping):
        raise ValueError(f"unsupported checkpoint format in {path}")
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if hasattr(v, "detach")}


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32)


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


# the torch modules that sit inside the port's head module
_HEAD_MODULES = {"conv2", "fc"}


def classifier_variables_from_torch(state_dict: Mapping[str, np.ndarray]
                                    ) -> Dict[str, Any]:
    """{'params': ..., 'batch_stats': ...} of the ErNET family from a
    reference state dict."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, val in state_dict.items():
        *module_path, leaf = key.split(".")
        module_path = tuple(module_path)
        if module_path and module_path[0] in _HEAD_MODULES:
            module_path = ("head",) + module_path
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight":
            if val.ndim == 4:
                _set(params, module_path + ("kernel",), _conv_kernel(val))
            elif val.ndim == 2:
                _set(params, module_path + ("kernel",),
                     np.transpose(val).astype(np.float32))
            elif val.ndim == 1:
                _set(params, module_path + ("scale",), val.astype(np.float32))
            else:
                raise ValueError(f"unexpected weight rank for {key}: "
                                 f"{val.shape}")
        elif leaf == "bias":
            _set(params, module_path + ("bias",), val.astype(np.float32))
        elif leaf == "running_mean":
            _set(stats, module_path + ("mean",), val.astype(np.float32))
        elif leaf == "running_var":
            _set(stats, module_path + ("var",), val.astype(np.float32))
        else:
            raise ValueError(f"unhandled key {key}")
    return {"params": params, "batch_stats": stats}


def infer_classifier_arch(state_dict: Mapping[str, np.ndarray]) -> str:
    """The architecture from a checkpoint's top-level keys: ``conv_red*``
    -> squeeze-redconv, ``acff5``/``acff6`` -> ernet, else squeeze-ernet
    (so full-module pickles name their own model)."""
    keys = {k.split(".")[0] for k in state_dict}
    if any(k.startswith("conv_red") for k in keys):
        return "squeeze-redconv"
    if "acff5" in keys or "acff6" in keys:
        return "ernet"
    return "squeeze-ernet"


def load_classifier_checkpoint(path: str) -> Dict[str, Any]:
    """The variables tree of the classifier checkpoint at ``path``."""
    return classifier_variables_from_torch(load_torch_state_dict(path))
