"""Per-layer model summaries, logged by the trainer at fit start.

Counterpart of ``lightning_generative_models_tpu/utils/summary.py``:

- ``param_table(model)``: one row per parameter (path, shape, dtype, count) under the
  flax names and shapes the JAX package's ``param_table(state.params)`` prints, from
  the model's ``flax_layout()`` (the ``params/<group>`` entries, the names
  ``weights.flax_paths`` maps), sorted as flax's tree is;
- ``module_table(module, example_args, compute_flops, depth, **kwargs)``: the layer tree
  down to ``depth``, each layer's output shape and parameter count, and with
  ``compute_flops`` its forward FLOPs (``torch.utils.flop_counter.FlopCounterMode``).
  It runs a CPU copy of the module in eval mode on the CPU example inputs, so that no
  kernel is launched and no state of the model moves; the trainer asks for FLOPs only
  when the model is on the CPU, as the JAX trainer computes them only on a local backend.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from lightning_generative_models_tpu_torch.weights import flax_paths

# The flax shape of a port parameter, by its ``FLAX_LEAVES`` transform (weights.py).
_FLAX_SHAPES = {
    None: lambda s: s,
    "conv": lambda s: (s[2], s[3], s[1], s[0]),            # OIHW -> HWIO
    "conv_transpose": lambda s: (s[2], s[3], s[0], s[1]),  # [in, out, h, w] -> HWIO
    "dense": lambda s: s[::-1],                            # [out, in] -> [in, out]
}


def param_rows(model: Any) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(path, flax shape, dtype, count) of every parameter of the model's ``params/``
    groups, in flax's order."""
    rows = []
    for prefix, module in model.flax_layout()["params"].items():
        if not prefix.startswith("params/"):
            continue
        group = prefix[len("params/"):]
        for path, (param, transform) in flax_paths(module).items():
            rows.append((f"{group}/{path}", tuple(_FLAX_SHAPES[transform](tuple(param.shape))),
                         str(param.dtype).replace("torch.", ""), param.numel()))
    return sorted(rows, key=lambda r: r[0].split("/"))


def param_table(model: Any, max_rows: int = 200) -> str:
    """The torchinfo-style parameter table of the JAX package's ``param_table``."""
    rows = [(name, str(shape), dtype, count) for name, shape, dtype, count in param_rows(model)]
    name_w = max([len(r[0]) for r in rows] + [10])
    shape_w = max([len(r[1]) for r in rows] + [7])
    rule = "-" * (name_w + shape_w + 30)
    lines = [f"{'layer':<{name_w}}  {'shape':<{shape_w}}  {'dtype':<10}  {'params':>12}", rule]
    for name, shape, dtype, count in rows[:max_rows]:
        lines.append(f"{name:<{name_w}}  {shape:<{shape_w}}  {dtype:<10}  {count:>12,}")
    if len(rows) > max_rows:
        lines.append(f"... ({len(rows) - max_rows} more rows)")
    lines.append(rule)
    total = sum(r[3] for r in rows)
    lines.append(f"{'total':<{name_w}}  {'':<{shape_w}}  {'':<10}  {total:>12,}")
    return "\n".join(lines)


def _shape(out: Any) -> str:
    if isinstance(out, torch.Tensor):
        return str(tuple(out.shape))
    if isinstance(out, (tuple, list)):
        return "(" + ", ".join(_shape(o) for o in out) + ")"
    return type(out).__name__


def module_rows(module: nn.Module, example_args: Sequence[Any], compute_flops: bool = True,
                depth: int = 2, **kwargs: Any) -> List[Dict[str, Any]]:
    """One row a layer down to ``depth``: path, type, output shape, parameters and
    (``compute_flops``) forward FLOPs, in call order (module doc)."""
    net = copy.deepcopy(module).cpu().eval()
    names = {m: n for n, m in net.named_modules() if n.count(".") < depth}
    rows: Dict[str, Dict[str, Any]] = {}

    def hook(mod, _inputs, out):
        name = names[mod] or type(net).__name__
        rows.setdefault(name, {"layer": name, "type": type(mod).__name__,
                               "output": _shape(out),
                               "params": sum(p.numel() for p in mod.parameters())})

    handles = [m.register_forward_hook(hook) for m in names]
    args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in example_args]
    kwargs = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
    try:
        with torch.no_grad():
            if compute_flops:
                from torch.utils.flop_counter import FlopCounterMode

                with FlopCounterMode(display=False) as counter:
                    net(*args, **kwargs)
                flops = {k.split(".", 1)[1] if "." in k else "": sum(v.values())
                         for k, v in counter.get_flop_counts().items() if k != "Global"}
                for name, row in rows.items():
                    row["flops"] = flops.get("" if name == type(net).__name__ else name, 0)
            else:
                net(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return list(rows.values())


def module_table(module: nn.Module, example_args: Sequence[Any], compute_flops: bool = True,
                 depth: int = 2, **kwargs: Any) -> str:
    """``module_rows`` as a table."""
    rows = module_rows(module, example_args, compute_flops, depth, **kwargs)
    cols = ["layer", "type", "output", "params"] + (["flops"] if compute_flops else [])
    cells = [[f"{r[c]:,}" if isinstance(r[c], int) else str(r[c]) for c in cols] for r in rows]
    widths = [max([len(c)] + [len(row[i]) for row in cells]) for i, c in enumerate(cols)]
    fmt = "  ".join(f"{{:<{w}}}" if i < 3 else f"{{:>{w}}}" for i, w in enumerate(widths))
    lines = [fmt.format(*cols), "-" * (sum(widths) + 2 * (len(cols) - 1))]
    lines += [fmt.format(*row) for row in cells]
    return "\n".join(lines)
