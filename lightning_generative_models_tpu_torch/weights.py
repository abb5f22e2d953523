"""Load a flax parameter tree into the port's modules.

The tree is what ``jax.device_get(state.ema_params)`` returns: nested dicts of numpy
arrays keyed by flax's module names (``Conv_0``, ``ResnetBlock_3/Block_1/GroupNorm_0``,
``LinearAttention_2``, ``class_emb``, ...), or the same tree flattened into an
``.npz`` whose keys are the "/"-joined paths. The port's modules carry the same names,
so each parameter's flax path is its module path plus the leaf name that its layer
declares in ``FLAX_LEAVES`` (conv kernels go from HWIO to OIHW, Dense kernels
[in, out] to [out, in], GroupNorm ``scale`` to ``weight``). Any missing or left-over
key, or a shape that does not fit, raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

Tree = Union[Mapping, str, Path]

_TRANSFORMS = {
    None: lambda a: a,
    "conv": lambda a: a.transpose(3, 2, 0, 1),  # HWIO -> OIHW
    "dense": lambda a: a.T,                      # [in, out] -> [out, in]
}


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": array}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def read_tree(tree: Tree) -> Dict[str, np.ndarray]:
    """A nested tree, a flat {"a/b": array} dict, or the path of an ``.npz`` -> flat dict."""
    if isinstance(tree, (str, Path)):
        with np.load(tree) as data:
            return {k: data[k] for k in data.files}
    return flatten_tree(tree)


def flax_paths(module: nn.Module) -> Dict[str, tuple]:
    """{flax path: (parameter, transform)} for every parameter of ``module``."""
    paths = {}
    for mod_name, mod in module.named_modules():
        leaves = getattr(type(mod), "FLAX_LEAVES", {})
        for p_name, param in mod.named_parameters(recurse=False):
            leaf, transform = leaves.get(p_name, (p_name, None))
            prefix = mod_name.replace(".", "/")
            paths[f"{prefix}/{leaf}" if prefix else leaf] = (param, transform)
    return paths


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Tree) -> nn.Module:
    """Copy a flax parameter tree into ``module`` in place (see the module doc)."""
    flat = read_tree(tree)
    expected = flax_paths(module)
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f"flax tree does not fit the module: missing {missing}, left over {extra}")
    for path, (param, transform) in expected.items():
        value = _TRANSFORMS[transform](np.asarray(flat[path], np.float32))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(
                f"{path}: flax shape {tuple(flat[path].shape)} does not fit "
                f"{tuple(param.shape)}"
            )
        param.copy_(torch.tensor(value))
    return module
