"""Weight archives and the mapping between the JAX tree and PyTorch names.

Counterpart of ``rtdm_tpu/models/io.py``: ``.npz`` archives (flat
``collection/path/to/leaf`` -> array) through ``flatten_tree``,
``unflatten_tree``, ``save_variables``, ``load_variables`` (with sealed
``<leaf>.q`` int8 codes and ``<leaf>.s`` scales dequantized; a ``.pt`` or
``.pth`` goes to ``models/torch_import.py``) and ``infer_num_classes``;
``tree_digest`` names a tree's contents.

``torch_state_dict_from_variables`` carries a variables tree onto the port's
modules, whose submodules are named as the tree is (``conv1``,
``acff1.conv1``, ``head.fc``; the detectors' ``l{i}_conv``,
``m{i}.cv1.conv``, ``m{i}_{j}``, ``m{i}_m{level}``): conv kernels HWIO ->
OIHW (depthwise (3,3,1,C) -> (C,1,3,3)), dense (I,O) -> (O,I), BN
``scale``/``bias`` -> ``weight``/``bias``,
``batch_stats/.../mean``/``var`` -> ``running_mean``/``running_var``, and
any other 1-D leaf (a weighted shortcut's ``l{i}_w``, the parametric
activations' ``p1``, ``p2``, ``beta``) and a v5 transformer's (in, out)
matrices (``q_w``, ``in_q_w``, ``linear_w``, ...) under their own names.
``variables_from_torch_state_dict`` is its inverse.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def numpy_tree(tree: Any) -> Any:
    """A deep copy of a tree with every leaf a numpy array."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def tree_digest(tree: Any) -> str:
    """sha256 of a tree's leaves (keys, dtypes, shapes and bytes, in key
    order): equal for equal trees, wherever they were made."""
    import hashlib
    h = hashlib.sha256()
    for key, val in sorted(flatten_tree(tree).items()):
        val = np.ascontiguousarray(val)
        h.update(f"{key}:{val.dtype.str}:{val.shape};".encode())
        h.update(val.tobytes())
    return h.hexdigest()


def save_variables(path: str, variables: Dict[str, Any]) -> str:
    """Write {'params': ..., 'batch_stats': ...} as a flat .npz."""
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **flatten_tree(variables))
    return path


def load_variables(path: str) -> Dict[str, Any]:
    """Load classifier variables from a torch ``.pt``/``.pth`` checkpoint
    (``models/torch_import.py``) or an ``.npz`` archive."""
    if path.endswith((".pt", ".pth")):
        from rtdm_tpu_torch.models.torch_import import \
            load_classifier_checkpoint
        return load_classifier_checkpoint(path)
    with np.load(path) as archive:
        flat = dict(archive)
    # sealed archives store int8 weight codes + per-channel scales
    # ('<leaf>.q' int8 / '<leaf>.s' fp32); q*s is the QDQ'd kernel.
    for key in [k for k in flat if k.endswith(".q")]:
        base = key[:-2]
        scale = flat.pop(base + ".s")
        flat[base] = flat.pop(key).astype(np.float32) * scale
    tree = unflatten_tree(flat)
    tree.setdefault("batch_stats", {})
    return tree


def infer_num_classes(variables) -> "int | None":
    """Class count from the kernel of the classifier's 'fc' head; None when
    no fc head is found."""
    for key, val in flatten_tree(variables).items():
        if key.endswith("fc/kernel"):
            return int(np.shape(val)[-1])
    return None


_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}


def torch_state_dict_from_variables(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX variables tree of arrays to the port's state_dict (CPU
    tensors, dtypes as stored)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in flatten_tree(variables.get("params", {})).items():
        *path, leaf = key.split("/")
        arr = np.asarray(val)
        if leaf == "kernel" and arr.ndim == 4:
            arr, leaf = arr.transpose(3, 2, 0, 1), "weight"   # HWIO -> OIHW
        elif leaf == "kernel" and arr.ndim == 2:
            arr, leaf = arr.T, "weight"                       # (I,O) -> (O,I)
        elif leaf == "scale":
            leaf = "weight"                                   # BN gamma
        elif leaf == "weight" or (arr.ndim != 1 and not leaf.endswith("_w")):
            raise KeyError(f"unmapped parameter {key}")
        out[".".join(path + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    for key, val in flatten_tree(variables.get("batch_stats", {})).items():
        *path, leaf = key.split("/")
        if leaf not in _STATS:
            raise KeyError(f"unmapped batch stat {key}")
        out[".".join(path + [_STATS[leaf]])] = torch.from_numpy(
            np.ascontiguousarray(val))
    return out


def variables_from_torch_state_dict(
        state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``torch_state_dict_from_variables``: a JAX-layout tree of
    float32 numpy arrays."""
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        arr = t.detach().cpu().float().numpy()
        if leaf in _STATS_INV:
            stats["/".join(path + [_STATS_INV[leaf]])] = arr
            continue
        if leaf == "weight" and arr.ndim == 4:
            arr, leaf = arr.transpose(2, 3, 1, 0), "kernel"   # OIHW -> HWIO
        elif leaf == "weight" and arr.ndim == 2:
            arr, leaf = arr.T, "kernel"
        elif leaf == "weight":
            leaf = "scale"
        elif arr.ndim != 1 and not leaf.endswith("_w"):
            raise KeyError(f"unmapped tensor {name}")
        params["/".join(path + [leaf])] = np.ascontiguousarray(arr)
    return {"params": unflatten_tree(params),
            "batch_stats": unflatten_tree(stats)}
