"""Load a flax parameter tree, or a whole JAX ``TrainState``, into the port.

The tree is what ``jax.device_get(state.ema_params)`` returns: nested dicts of numpy
arrays keyed by flax's module names (``Conv_0``, ``ResnetBlock_3/Block_1/GroupNorm_0``,
``LinearAttention_2``, ``class_emb``, ...), or the same tree flattened into an
``.npz`` whose keys are the "/"-joined paths. ``load_flax_train_state`` reads a whole
``TrainState`` the same way (``jax.device_get(state)``, or its flattening into an
``.npz``: dataclass fields and named-tuple fields by name, tuple items by index), so
that the port can continue a JAX run: the raw and EMA weights, Adam's moments and
step count, and the model's step. The port's modules carry the same names,
so each parameter's flax path is its module path plus the leaf name that its layer
declares in ``FLAX_LEAVES`` (conv kernels go from HWIO to OIHW, Dense kernels
[in, out] to [out, in], GroupNorm ``scale`` to ``weight``). Any missing or left-over
key, or a shape that does not fit, raises.
"""

from __future__ import annotations

import dataclasses
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


def _children(node):
    """(name, child) pairs of a container node, or None for a leaf."""
    if isinstance(node, Mapping):
        return list(node.items())
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts (and dataclasses, named tuples, tuples) -> {"a/b/c": array}.
    ``None`` leaves are dropped."""
    flat = {}
    for key, value in _children(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if value is None:
            continue
        if _children(value) is not None:
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def read_tree(tree) -> Dict[str, np.ndarray]:
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


def _subtree(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    sub = {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}
    if not sub:
        raise KeyError(f"the train state has no '{prefix}' entries")
    return sub


@torch.no_grad()
def load_flax_train_state(ddpm, tree) -> None:
    """Fill a port ``DDPM`` from a JAX ``TrainState`` (see the module doc): ``params/model``
    to ``ddpm.unet``, ``ema_params`` to ``ddpm.ema_unet``, optax's Adam state
    ``opt_state/model/0/{mu,nu,count}`` to the optimizer's ``exp_avg``,
    ``exp_avg_sq`` and ``step``, and ``step`` to ``ddpm.step``."""
    flat = read_tree(tree)
    load_flax_params(ddpm.unet, _subtree(flat, "params/model"))
    load_flax_params(ddpm.ema_unet, _subtree(flat, "ema_params"))
    adam = "opt_state/model/0"
    mu, nu = _subtree(flat, f"{adam}/mu"), _subtree(flat, f"{adam}/nu")
    count = float(np.asarray(flat[f"{adam}/count"]))
    for path, (param, transform) in flax_paths(ddpm.unet).items():
        if not param.requires_grad:
            continue
        ddpm.optimizer.state[param] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(_TRANSFORMS[transform](
                np.asarray(mu[path], np.float32))).to(param),
            "exp_avg_sq": torch.tensor(_TRANSFORMS[transform](
                np.asarray(nu[path], np.float32))).to(param),
        }
    ddpm.step = int(np.asarray(flat["step"]))
