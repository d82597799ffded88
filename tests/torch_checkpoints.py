"""Reference-layout torch checkpoints written from JAX-layout trees, for the
import tests.

The repository holds no ``.pt`` or ``.weights`` file; the tests write them
from the committed ``.npz`` trees in the layouts the reference's tools
save: a classifier state dict (``conv1.weight``, ``acff1.conv1.weight``,
``acff1.batch_norm.running_var``, ``...num_batches_tracked``,
``conv2.weight``, ``fc.weight``), the trainer's ``{'model_state_dict':
...}``, a pickled module of classes that are not importable when it is
read, and the darknet fork's ``{'model': state_dict}`` with
``module_list.{i}.Conv2d``/``BatchNorm2d``/``acff_{i}.*`` keys.
"""

import sys
import types

import numpy as np
import torch
from torch import nn

from rtdm_tpu_torch.models.io import torch_state_dict_from_variables

CLASSIFIER_LAYOUTS = ("state_dict", "model_state_dict", "module")


def classifier_state_dict(variables):
    """The reference classifier's state dict of a JAX-layout tree: the
    port's names without ``head.``, and a ``num_batches_tracked`` per
    BatchNorm."""
    out = {}
    for key, val in torch_state_dict_from_variables(variables).items():
        key = key[len("head."):] if key.startswith("head.") else key
        out[key] = val.float().clone()
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    return out


def _module_of(state, module_name):
    """An ``nn.Module`` tree of classes defined in a module named
    ``module_name`` that holds ``state`` as parameters and buffers (running
    statistics and counters), as a pickled training-code model does."""
    mod = types.ModuleType(module_name)
    for cls_name in ("ErNET", "Block"):
        setattr(mod, cls_name, type(cls_name, (nn.Module,),
                                    {"__module__": module_name}))
    root = mod.ErNET()
    for key, val in state.items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            if p not in node._modules:
                node.add_module(p, mod.Block())
            node = node._modules[p]
        if leaf.startswith(("running_", "num_batches")):
            node.register_buffer(leaf, val)
        else:
            node.register_parameter(leaf, nn.Parameter(val))
    return mod, root


def save_classifier_pt(path, variables, layout, module_name="legacy_aider"):
    """Write ``variables`` as a reference classifier checkpoint in
    ``layout`` (one of ``CLASSIFIER_LAYOUTS``); the "module" layout pickles
    classes of ``module_name``, which is importable only while saving."""
    state = classifier_state_dict(variables)
    if layout == "state_dict":
        torch.save(state, path)
    elif layout == "model_state_dict":
        torch.save({"model_state_dict": state, "epoch": 3}, path)
    else:
        mod, root = _module_of(state, module_name)
        sys.modules[module_name] = mod
        try:
            torch.save(root, path)
        finally:
            del sys.modules[module_name]
    return str(path)


def darknet_fork_state_dict(variables, cfg_text):
    """The fork's darknet state dict (``module_list.{i}.Conv2d.weight``,
    ``.BatchNorm2d.*``, ``.acff_{i}.<conv1|conv2|conv3|fused_conv|
    batch_norm>.*``, a weighted shortcut's ``.w``) of a JAX-layout
    detector tree."""
    from rtdm_tpu_torch.models.darknet import parse_darknet_cfg
    port = torch_state_dict_from_variables(variables)
    acff = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
            "fused": "fused_conv", "bn": "batch_norm"}
    out = {}
    for i in range(len(parse_darknet_cfg(cfg_text)) - 1):
        for key, val in port.items():
            name, _, leaf = key.partition(".")
            if name == f"l{i}_conv":
                out[f"module_list.{i}.Conv2d.{leaf}"] = val
            elif name == f"l{i}_bn":
                out[f"module_list.{i}.BatchNorm2d.{leaf}"] = val
            elif name.startswith(f"l{i}_acff_"):
                sub = acff[name[len(f"l{i}_acff_"):]]
                out[f"module_list.{i}.acff_{i}.{sub}.{leaf}"] = val
            elif name == f"l{i}_w":
                out[f"module_list.{i}.w"] = val
    for key in [k for k in out if k.endswith(".running_var")]:
        out[key[:-len("running_var")] + "num_batches_tracked"] = \
            torch.tensor(3)
    return {k: v.float().clone() for k, v in out.items()}


def randomized_tree(tree, seed):
    """``tree`` with every leaf replaced by seeded normal values of its
    shape (variances positive)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        val = rng.normal(size=np.shape(node)).astype(np.float32)
        return np.abs(val) + 0.5 if name == "var" else val
    return walk(tree)
