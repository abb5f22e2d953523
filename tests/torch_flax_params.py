"""Flax parameter trees for the port's parity tests, drawn by the port's own init.

A flax ``init`` on the CPU costs 10-30 s for the tests' tiny models (the threefry draws
and the forward it traces compile), most of a parity test. The port draws the same
distributions in milliseconds, so the tests draw the weights there and hand them to
both sides: ``flax_tree`` turns a port module's parameters back into the flax tree
(the inverse of ``weights.load_flax_params``' transforms) and checks it against the
tree of shapes that ``jax.eval_shape`` of the flax ``init`` gives, which compiles
nothing. The paths and shapes are thus flax's own, key for key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lightning_generative_models_tpu_torch.weights import _TRANSFORMS, flatten_tree, flax_paths

_INVERSE = {
    None: lambda a: a,
    "conv": lambda a: a.transpose(2, 3, 1, 0),  # OIHW -> HWIO
    "conv_transpose": lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
    "dense": lambda a: a.T,  # [out, in] -> [in, out]
}


def flax_tree(module, flax_shapes, buffers: bool = False) -> dict:
    """The parameters (``buffers=True``: the buffers) of a port ``module`` as a nested
    flax tree of f32 numpy arrays. Raises AssertionError unless its paths and shapes are
    exactly those of ``flax_shapes`` (a tree of ``jax.ShapeDtypeStruct``)."""
    tree, shapes = {}, {}
    for path, (tensor, transform) in flax_paths(module, buffers).items():
        # A copy: a view would alias the tensor, and a JAX array made from it would see
        # the port's in-place updates (BatchNorm buffers, optimizer steps) whenever JAX's
        # asynchronous dispatch reads it late.
        value = np.array(_INVERSE[transform](tensor.detach().float().numpy()), order="C")
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
        shapes[path] = value.shape
    want = {"/".join(_key_name(k) for k in keys): tuple(leaf.shape)
            for keys, leaf in jax.tree_util.tree_flatten_with_path(flax_shapes)[0]}
    assert shapes == want, (sorted(set(shapes) ^ set(want)),
                            {p: (shapes.get(p), want.get(p)) for p in want
                             if shapes.get(p) != want[p]})
    return tree


def init_shapes(jax_module, *args, **kwargs):
    """The ``params`` tree of ``jax_module.init(key, *args, **kwargs)`` as shapes."""
    return jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *args, **kwargs)["params"]


def _key_name(key) -> str:
    return str(getattr(key, "key", getattr(key, "name", getattr(key, "idx", key))))


def _subtree(tree, prefix: str):
    for name in prefix.split("/"):
        tree = tree[name] if isinstance(tree, dict) else getattr(tree, name)
    return tree


def state_from_port(jax_model, port_model):
    """The JAX model's ``init_state`` as it would be with the port model's weights: the
    tree of ``jax.eval_shape(init_state)`` (nothing compiles), its weights, mutable
    variables and carried tensors filled from the port modules and tensors that
    ``port_model.flax_layout()`` names, the optimizers' states fresh (optax's Adam starts at
    count 0 with zero moments, its RMSprop with a zero nu) and the step 0."""
    shapes = jax.eval_shape(jax_model.init_state, jax.random.PRNGKey(0))
    layout = port_model.flax_layout()
    values = {}
    for kind, buffers in (("params", False), ("buffers", True)):
        for prefix, module in layout.get(kind, {}).items():
            tree = flax_tree(module, _subtree(shapes, prefix), buffers=buffers)
            values.update({f"{prefix}/{path}": v for path, v in flatten_tree(tree).items()})
    for path, tensor in layout.get("tensors", {}).items():
        values[path] = tensor.detach().float().cpu().numpy().reshape(
            _subtree(shapes, path).shape)
    fresh = tuple(prefix + "/" for kind in ("adam", "rmsprop")
                  for prefix in layout.get(kind, {})) + ("step",)

    def fill(keys, leaf):
        path = "/".join(_key_name(k) for k in keys)
        if path in values:
            return jnp.asarray(values.pop(path))
        assert path.startswith(fresh), f"no port value for {path}"
        return jnp.asarray(np.zeros(leaf.shape, leaf.dtype))  # no compile per shape

    state = jax.tree_util.tree_map_with_path(fill, shapes)
    assert not values, f"port values left over: {sorted(values)}"
    return state


def as_port(module, jax_tree) -> list:
    """A flax-shaped tree of ``module``'s parameters (weights, grads or Adam moments) as
    tensors in the order of ``module.parameters()``."""
    flat = flatten_tree(jax.device_get(jax_tree))
    by_param = {id(p): (path, tr) for path, (p, tr) in flax_paths(module).items()}
    return [torch.tensor(_TRANSFORMS[by_param[id(p)][1]](
        np.asarray(flat[by_param[id(p)][0]], np.float32))) for p in module.parameters()]


def k_bias_mask(module, layout: str = "s3hd", heads: int = 1) -> torch.Tensor:
    """True on the k part of every DiT qkv bias (s3hd: channels [hd, 2 hd); h3d: each
    head's middle d of its [3, d]), in the order of the module's parameters. Adding the
    same vector to every key moves each query's logits by a constant, which the softmax
    ignores: its gradient is exactly 0, and both frameworks return f32 noise there
    (~1e-9), which Adam's first steps turn into a move of +-lr with a random sign."""
    masks = []
    for name, p in module.named_parameters():
        m = torch.zeros(p.numel(), dtype=torch.bool)
        if name.endswith("qkv.bias"):
            hd = p.numel() // 3
            if layout == "h3d":
                m.view(heads, 3, hd // heads)[:, 1] = True
            else:
                m[hd:2 * hd] = True
        masks.append(m)
    return torch.cat(masks)
