"""Load a flax parameter tree, or a whole JAX ``TrainState``, into the port.

The tree is what ``jax.device_get(state.ema_params)`` returns: nested dicts of numpy
arrays keyed by flax's module names (``Conv_0``, ``ResnetBlock_3/Block_1/GroupNorm_0``,
``LinearAttention_2``, ``class_emb``, ...), or the same tree flattened into an
``.npz`` whose keys are the "/"-joined paths. ``load_flax_train_state`` reads a whole
``TrainState`` the same way (``jax.device_get(state)``, or its flattening into an
``.npz``: dataclass fields and named-tuple fields by name, tuple items by index), so
that the port can continue a JAX run: the weights (raw and EMA), the variables of
mutable collections (the EMA codebook's ``mutable/vq/codebook``, into buffers), Adam's
moments and step count, and the model's step. Which subtree fills which module is the
model's ``flax_layout()``. The port's modules carry the same names, so each
parameter's (or buffer's) flax path is its module path plus the leaf name that its
layer declares in ``FLAX_LEAVES`` (conv kernels go from HWIO to OIHW, transposed-conv
kernels from HWIO to a spatially flipped [in, out, h, w], Dense kernels [in, out] to
[out, in], GroupNorm ``scale`` to ``weight``). Any missing or left-over key, or a
shape that does not fit, raises. A pipeline DiT's stage-stacked leaves
(``pipeline/stages/block_j/...`` [S, ...], global block ``s depth / S + j``) are read as
the port's per-stage paths (``pipeline/stages/{s}/block_j/...``), in the weights and in
Adam's moments alike; the trainer lays the whole tree out for its strategy after.
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
    # HWIO -> [in, out, kh, kw], flipped in both spatial axes (layers.ConvTranspose)
    "conv_transpose": lambda a: np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1)),
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


def unstack_stages(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """JAX's stage-stacked pipeline leaves ``.../pipeline/stages/block_j/...`` [S, ...]
    as S leaves ``.../pipeline/stages/{s}/block_j/...``; other keys as they are."""
    out = {}
    for key, value in flat.items():
        head, sep, tail = key.partition("pipeline/stages/")
        if sep and tail.startswith("block_"):
            for s in range(value.shape[0]):
                out[f"{head}pipeline/stages/{s}/{tail}"] = value[s]
        else:
            out[key] = value
    return out


def read_tree(tree) -> Dict[str, np.ndarray]:
    """A nested tree, a flat {"a/b": array} dict, or the path of an ``.npz`` -> flat dict
    (stage-stacked pipeline leaves split: ``unstack_stages``)."""
    if isinstance(tree, (str, Path)):
        with np.load(tree) as data:
            return unstack_stages({k: data[k] for k in data.files})
    return unstack_stages(flatten_tree(tree))


def flax_paths(module: nn.Module, buffers: bool = False) -> Dict[str, tuple]:
    """{flax path: (parameter, transform)} for every parameter of ``module`` (every
    buffer with ``buffers=True``: the variables of a flax mutable collection)."""
    paths = {}
    for mod_name, mod in module.named_modules():
        leaves = getattr(type(mod), "FLAX_LEAVES", {})
        named = mod.named_buffers if buffers else mod.named_parameters
        for p_name, param in named(recurse=False):
            leaf, transform = leaves.get(p_name, (p_name, None))
            prefix = mod_name.replace(".", "/")
            paths[f"{prefix}/{leaf}" if prefix else leaf] = (param, transform)
    return paths


def _converted(path: str, value: np.ndarray, transform, target: torch.Tensor) -> torch.Tensor:
    out = _TRANSFORMS[transform](np.asarray(value, np.float32))
    if tuple(out.shape) != tuple(target.shape):
        raise ValueError(f"{path}: flax shape {tuple(np.shape(value))} does not fit "
                         f"{tuple(target.shape)}")
    return torch.tensor(out)


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Tree, buffers: bool = False) -> nn.Module:
    """Copy a flax parameter tree into ``module`` in place (see the module doc); with
    ``buffers=True`` a mutable collection's tree into its buffers."""
    flat = read_tree(tree)
    expected = flax_paths(module, buffers)
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f"flax tree does not fit the module: missing {missing}, left over {extra}")
    for path, (param, transform) in expected.items():
        param.copy_(_converted(path, flat[path], transform, param))
    return module


def _subtree(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def _adam_path(flat: Dict[str, np.ndarray], opt_prefix: str) -> str:
    """Where optax's Adam state sits in the optimizer state at ``opt_prefix``, found by
    its ``count`` field: ``opt_prefix/0`` for a bare Adam chain, ``opt_prefix/1`` when
    weight decay comes first."""
    found = [k[:-len("/count")] for k in flat
             if k.startswith(opt_prefix + "/") and k.endswith("/count")]
    if len(found) != 1:
        raise KeyError(f"expected one Adam state (a 'count') under '{opt_prefix}', "
                       f"found {found}")
    return found[0]


@torch.no_grad()
def load_flax_adam(optimizer: torch.optim.Optimizer, flat: Dict[str, np.ndarray],
                   opt_prefix: str, modules: Dict[str, nn.Module]) -> None:
    """Fill the port's Adam state (its moments in the optimizer's dtypes) from optax's
    ``{count, mu, nu}`` at ``opt_prefix``:
    ``modules`` maps a subtree of the moments ("" for the whole) to the module whose
    parameters it covers."""
    adam = _adam_path(flat, opt_prefix)
    mu, nu = _subtree(flat, f"{adam}/mu"), _subtree(flat, f"{adam}/nu")
    count = float(np.asarray(flat[f"{adam}/count"]))
    for sub, module in modules.items():
        for path, (param, transform) in flax_paths(module).items():
            if not param.requires_grad:
                continue
            key = f"{sub}/{path}" if sub else path
            mu_dtype, nu_dtype = optimizer.moment_dtypes(param)
            optimizer.state[param] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": _converted(key, mu[key], transform, param).to(param.device,
                                                                         mu_dtype),
                "exp_avg_sq": _converted(key, nu[key], transform, param).to(param.device,
                                                                            nu_dtype),
            }


@torch.no_grad()
def load_flax_rmsprop(optimizer: torch.optim.Optimizer, flat: Dict[str, np.ndarray],
                      opt_prefix: str, modules: Dict[str, nn.Module]) -> None:
    """Fill ``train/state.py``'s RMSprop from optax's ``ScaleByRmsState`` (its ``nu``) at
    ``opt_prefix``, with ``modules`` as in ``load_flax_adam``."""
    found = {k[:k.index("/nu/")] for k in flat
             if k.startswith(opt_prefix + "/") and "/nu/" in k}
    if len(found) != 1:
        raise KeyError(f"expected one RMSprop state (a 'nu') under '{opt_prefix}', "
                       f"found {sorted(found)}")
    nu = _subtree(flat, f"{found.pop()}/nu")
    for sub, module in modules.items():
        for path, (param, transform) in flax_paths(module).items():
            key = f"{sub}/{path}" if sub else path
            optimizer.state[param] = {"nu": _converted(key, nu[key], transform, param).to(param)}


@torch.no_grad()
def load_flax_train_state(model, tree, optimizers: bool = True) -> None:
    """Fill a port model from a JAX ``TrainState`` (see the module doc), as its
    ``flax_layout()`` maps it: ``{"params": {tree prefix: module}, "buffers": {tree
    prefix: module}, "tensors": {tree path: tensor}, "adam" / "rmsprop":
    {optimizer-state prefix: (optimizer, {moments subtree: module})}}``; then ``step`` to
    ``model.step``. A DDPM (EDM, ConsistencyModel alike) maps ``params/model`` and
    ``ema_params``, a latent model also its autoencoder's ``mutable/autoencoder/...``; a
    VAE ``params/{encoder,decoder}``; a VQ-VAE ``params/{encoder,decoder,vq}``,
    ``mutable/vq/codebook`` and ``opt_state/model``; a VQGAN also ``params/disc`` and
    ``opt_state/disc`` (and its LPIPS at ``mutable/lpips``); BEGAN its ``mutable/k_t`` as
    a tensor. ``optimizers=False`` loads the weights (and the tensors) alone."""
    flat = read_tree(tree)
    layout = model.flax_layout()
    for kind, buffers in (("params", False), ("buffers", True)):
        for prefix, module in layout.get(kind, {}).items():
            sub = _subtree(flat, prefix)
            if not sub and flax_paths(module, buffers):
                raise KeyError(f"the train state has no '{prefix}' entries")
            load_flax_params(module, sub, buffers=buffers)
    for path, tensor in layout.get("tensors", {}).items():
        tensor.copy_(torch.tensor(np.asarray(flat[path], np.float32)).reshape(tensor.shape))
    if optimizers:
        for kind, load in (("adam", load_flax_adam), ("rmsprop", load_flax_rmsprop)):
            for prefix, (optimizer, modules) in layout.get(kind, {}).items():
                load(optimizer, flat, prefix, modules)
        model.step = int(np.asarray(flat["step"]))


# The flax InceptionV3 (JAX ``metrics/inception.py``) names its submodules by type in
# creation order: the stem's ``BasicConv_0..4``, then ``InceptionA_0..2``, ``InceptionB_0``,
# ``InceptionC_0..3``, ``InceptionD_0``, ``InceptionE_0..1`` and the head ``Dense_0``;
# inside a block ``BasicConv_j`` is its j-th conv in the torchvision definition order.
_INCEPTION_BLOCKS = (
    [(f"BasicConv_{i}", name) for i, name in enumerate(
        ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
         "Conv2d_4a_3x3"))]
    + [(f"InceptionA_{i}", name) for i, name in enumerate(("Mixed_5b", "Mixed_5c",
                                                             "Mixed_5d"))]
    + [("InceptionB_0", "Mixed_6a")]
    + [(f"InceptionC_{i}", name) for i, name in enumerate(("Mixed_6b", "Mixed_6c",
                                                             "Mixed_6d", "Mixed_6e"))]
    + [("InceptionD_0", "Mixed_7a")]
    + [(f"InceptionE_{i}", name) for i, name in enumerate(("Mixed_7b", "Mixed_7c"))]
)


def inception_flax_paths(net: nn.Module) -> Dict[str, tuple]:
    """{flax variable path: (tensor, transform)} of the port's ``InceptionV3``: every
    conv kernel (HWIO -> OIHW), BatchNorm ``scale``/``bias`` (``params``) and
    ``mean``/``var`` (``batch_stats``), and the ``Dense_0`` head."""
    paths = {}

    def basic_conv(flax_prefix: str, module: nn.Module) -> None:
        paths[f"params/{flax_prefix}/Conv_0/kernel"] = (module.conv.weight, "conv")
        for leaf, tensor in (("scale", module.bn.weight), ("bias", module.bn.bias)):
            paths[f"params/{flax_prefix}/BatchNorm_0/{leaf}"] = (tensor, None)
        for leaf, tensor in (("mean", module.bn.running_mean),
                             ("var", module.bn.running_var)):
            paths[f"batch_stats/{flax_prefix}/BatchNorm_0/{leaf}"] = (tensor, None)

    for flax_name, port_name in _INCEPTION_BLOCKS:
        block = getattr(net, port_name)
        if flax_name.startswith("BasicConv_"):
            basic_conv(flax_name, block)
            continue
        for j, (_, conv) in enumerate(block.named_children()):
            basic_conv(f"{flax_name}/BasicConv_{j}", conv)
    paths["params/Dense_0/kernel"] = (net.fc.weight, "dense")
    paths["params/Dense_0/bias"] = (net.fc.bias, None)
    return paths


@torch.no_grad()
def load_flax_inception(net: nn.Module, variables: Tree) -> nn.Module:
    """The flax InceptionV3's variables (``{"params", "batch_stats"}``, nested or "/"-keyed,
    or an ``.npz``) into the port's ``InceptionV3`` ``net``; any unmatched leaf on either
    side, or a shape that does not fit, raises."""
    flat = read_tree(variables)
    expected = inception_flax_paths(net)
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f"flax InceptionV3 variables do not fit: missing {missing}, "
                       f"left over {extra}")
    for path, (tensor, transform) in expected.items():
        tensor.copy_(_converted(path, flat[path], transform, tensor))
    return net
