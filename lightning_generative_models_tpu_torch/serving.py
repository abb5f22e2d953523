"""Serving export: freeze a trained sampler into one self-contained ``torch.export`` artifact.

Counterpart of ``lightning_generative_models_tpu/serving.py``. The serving unit is a
*frozen sampler*: the model's sampler with its weights, its labels and its schedule baked
in as constants, exported with ``torch.export`` and saved with ``torch.export.save`` to
one file that a serving process loads and calls with nothing but a seed: no model code, no
config, no checkpoint on the serving side (``load_artifact`` imports only the kernels' ops
module, whose custom ops the program calls on the card).

``torch.export`` takes no ``torch.Generator``, so the exported program takes its random
draws as inputs: the starts (``x_T``, a GAN's ``z``, InfoGAN's z and code ends, VQ codes,
PixelCNN's zero image) and the per-step draws stacked as ``[steps, ...]``. The sidecar
records the *draw plan* (each input's name, shape, distribution (``utils/draws.py``:
normal, uniform, randint below ``high``, gumbel, or zeros, which draws nothing) and order,
and which steps draw), and ``ServingArtifact(seed)`` draws the plan from a
``torch.Generator`` on the artifact's device seeded with ``seed``, one call per draw in the
live sampler's order, so that ``artifact(s)`` equals
``model.sample(torch.Generator(device).manual_seed(s), B, ...)``.

The sampler's loop is a ``Chain`` (``models/diffusion/gaussian_diffusion.py``): the same
step functions that the live ``sample`` drives in Python, here each segment one
``torch._higher_order_ops.scan``, so that the program holds one copy of the network per
segment whatever the step count (JAX: one ``lax.scan``). An artifact exported on the card
calls kernels #1, #3 and #6 as ``lgm_torch::`` custom ops; one exported on the CPU holds the
plain versions, and ``load_artifact`` refuses to run it on another device than its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree
from torch.nn.utils import stateless

from lightning_generative_models_tpu_torch.ops.common import register_ops, resolve_device
from lightning_generative_models_tpu_torch.utils.draws import make_draw, zeros_like_draw

__all__ = [
    "ExportedSampler",
    "ServingArtifact",
    "export_sampler",
    "save_artifact",
    "load_artifact",
]

FORMAT = "torch.export.ExportedProgram"


@dataclasses.dataclass(frozen=True)
class ExportedSampler:
    """What ``export_sampler`` returns: the program, its draw plan and its device."""

    program: Any  # torch.export.ExportedProgram
    draw_plan: List[dict]
    device: str
    output_shape: List[int]
    output_dtype: str


def draw(plan: List[dict], generator: torch.Generator, device) -> List[torch.Tensor]:
    """The plan's inputs drawn from ``generator``, one call per draw in order: a start
    tensor as one draw of its distribution; a per-step stack with a draw at each of its
    ``draw_steps`` (zeros at the steps that take none)."""
    inputs = []
    for entry in plan:
        dist, high = entry["distribution"], entry.get("high")
        if "draw_steps" not in entry:
            inputs.append(make_draw(dist, entry["shape"], generator, device, high))
            continue
        stack = zeros_like_draw(dist, entry["shape"], device)
        for i in entry["draw_steps"]:
            stack[i] = make_draw(dist, entry["shape"][1:], generator, device, high)
        inputs.append(stack)
    return inputs


class _ScanLoop(torch.fx.Interpreter):
    """Runs a loaded program's graph, each ``scan`` node as a loop that calls its body
    once a row. (torch 2.11's eager scan calls the body once more, on the first row, to
    size its outputs: one network evaluation a segment more than the sampler makes.)"""

    def call_function(self, target, args, kwargs):
        if target is not torch.ops.higher_order.scan:
            return super().call_function(target, args, kwargs)
        body, init, xs, additional = args
        carry, ys = list(init), []
        for i in range(xs[0].shape[0]):
            out = body(*carry, *(x[i] for x in xs), *additional)
            carry, y = list(out[:len(init)]), out[len(init):]
            ys.append(y)
        return [*carry, *(torch.stack(list(col)) for col in zip(*ys))]


@dataclasses.dataclass(frozen=True)
class ServingArtifact:
    """A loaded frozen sampler plus its provenance sidecar."""

    program: Any  # torch.export.ExportedProgram
    meta: dict
    device: torch.device
    module: Any  # program.module(), made once

    def run(self, *draws: torch.Tensor) -> torch.Tensor:
        """The program on explicit draws (the plan's inputs, in order), in inference
        mode: [batch, H, W, C] images in [0, 1]."""
        with torch.inference_mode():
            out = _ScanLoop(self.module).run(*(d.to(self.device) for d in draws))
            return out[0] if isinstance(out, (tuple, list)) else out

    def __call__(self, seed: int) -> torch.Tensor:
        """Run the frozen sampler on the plan drawn from a ``torch.Generator`` on the
        artifact's device seeded with ``seed``."""
        generator = torch.Generator(self.device).manual_seed(int(seed))
        return self.run(*draw(self.meta["draw_plan"], generator, self.device))


class _Sampler(torch.nn.Module):
    """The module that is exported: its forward builds the model's chain (the tables
    become the program's constants) and runs it as scan bodies on the draws.

    ``build() -> (chain, parts)``; the parts are what the chain reads: networks, registered
    as submodules, and plain objects holding tensors (a diffusion process's schedule, the
    guided closure's labels), whose tensors are registered as buffers and stand in for
    the object's own while the forward runs, so that ``torch.export`` lifts them as it
    lifts the weights."""

    def __init__(self, build):
        super().__init__()
        self.build = build
        _, parts = build()
        self.nets = torch.nn.ModuleDict(
            {k: v for k, v in parts.items() if isinstance(v, torch.nn.Module)})
        for name, obj in parts.items():
            if not isinstance(obj, torch.nn.Module):
                for attr in _tensor_attrs(obj):
                    self.register_buffer(f"{name}__{attr}", getattr(obj, attr),
                                         persistent=False)

    @contextlib.contextmanager
    def _holders_swapped(self, parts: dict):
        """The tensors of the parts that are not modules replaced by this module's
        buffers of the same names."""
        saved = []
        try:
            for name, obj in parts.items():
                if isinstance(obj, torch.nn.Module):
                    continue
                for attr in _tensor_attrs(obj):
                    saved.append((obj, attr, getattr(obj, attr)))
                    setattr(obj, attr, getattr(self, f"{name}__{attr}"))
            yield
        finally:
            for obj, attr, value in reversed(saved):
                setattr(obj, attr, value)

    def _scan(self, step, carry, xs, parts: dict):
        """``step`` over the rows of ``xs`` as one ``scan`` higher-order op whose body
        takes this module's weights and buffers as inputs (``additional_inputs``), so
        that ``torch.export`` traces the body once with ``make_fx`` at static shapes."""
        from torch._higher_order_ops.scan import scan_op  # noqa: PLC0415

        state = {**dict(self.named_parameters()), **dict(self.named_buffers())}
        names = list(state)
        c_leaves, c_spec = pytree.tree_flatten(carry)
        x_leaves, x_spec = pytree.tree_flatten(xs)
        nc, nx = len(c_leaves), len(x_leaves)

        def body(*args):
            c = pytree.tree_unflatten(list(args[:nc]), c_spec)
            row = pytree.tree_unflatten(list(args[nc:nc + nx]), x_spec)
            with stateless._reparametrize_module(self, dict(zip(names, args[nc + nx:]))):
                with self._holders_swapped(parts):
                    leaves = pytree.tree_leaves(step(c, row))
            return [*leaves, leaves[0].new_zeros(())]

        out = scan_op(body, c_leaves, x_leaves, additional_inputs=tuple(state.values()))
        return pytree.tree_unflatten(list(out[:nc]), c_spec)

    def forward(self, *draws: torch.Tensor):
        """The chain's segments, each one scan, on the plan's inputs: the chain's starts,
        then, when a step draws, the [steps, *shape] stack of every step's draw (zeros
        where a step draws nothing)."""
        chain, parts = self.build()
        n_starts = len(chain.start_draws())
        starts, noise = draws[:n_starts], draws[n_starts] if len(draws) > n_starts else None
        with self._holders_swapped(parts):
            carry, begin = chain.init(*starts), 0
            for seg in chain.segments:
                n = len(next(iter(seg.rows.values())))
                xs = dict(seg.rows)
                if seg.draws is not None:
                    xs["noise"] = noise[begin:begin + n]
                carry = self._scan(seg.step, carry, xs, parts)
                begin += n
            return chain.out(carry)


def _tensor_attrs(obj) -> List[str]:
    return [a for a, v in vars(obj).items() if isinstance(v, torch.Tensor)]


def _warm(chain, starts: Sequence[torch.Tensor]) -> None:
    """One step of each segment, on zeros: what the networks make at first use (the
    DiT's position table) exists before the trace, as a buffer that it lifts."""
    spec = chain.step_spec()
    with torch.no_grad():
        carry = chain.init(*starts)
        for seg in chain.segments:
            row = {name: col[0] for name, col in seg.rows.items()}
            if seg.draws is not None:
                row["noise"] = zeros_like_draw(spec.distribution, spec.shape,
                                               starts[0].device)
            carry = seg.step(carry, row)
        chain.out(carry)


def _plan_entry(spec, shape, order: int) -> dict:
    entry = {"name": spec.name, "shape": list(shape), "distribution": spec.distribution,
             "order": order}
    if spec.high is not None:
        entry["high"] = int(spec.high)
    return entry


def _draw_plan(chain) -> List[dict]:
    """The chain's starts in order, then the per-step stack when a step draws."""
    plan = [_plan_entry(spec, spec.shape, i) for i, spec in enumerate(chain.start_draws())]
    steps = chain.draw_steps()
    if steps:
        spec = chain.step_spec()
        plan.append({**_plan_entry(spec, [chain.steps(), *spec.shape], len(plan)),
                     "draw_steps": steps})
    return plan


def export_sampler(
    model,
    batch_size: int,
    method: Optional[str] = None,
    steps: Optional[int] = None,
    labels: Optional[Sequence[int]] = None,
    device: Optional[str] = None,
) -> ExportedSampler:
    """Freeze the model's sampler (``sample``, or ``sample_classes`` on ``labels``) into a
    ``torch.export`` program on the model's device (``device``, when given, must be it).

    The program's inputs are the draw plan's tensors; the weights (the EMA set of a
    diffusion model, a GAN's G in eval mode), the labels and the schedule are constants.
    A model with no sampler (the UNet autoencoder, CycleGAN) raises its ``sample``'s
    ``NotImplementedError``."""
    if labels is not None:
        if not hasattr(model, "sample_classes"):
            raise ValueError(
                f"{type(model).__name__} has no sample_classes; "
                "labels= is only valid for conditional models"
            )
        labels = [int(label) for label in labels]
        if len(labels) != batch_size:
            raise ValueError(f"{len(labels)} labels for a batch of {batch_size}")
    target = resolve_device(device or model.device)
    if target != torch.device(model.device):
        raise ValueError(f"the model lives on {model.device}; build it on {target} to "
                         f"export for {target}")

    def build():
        return model.serving_chain(batch_size, method=method, steps=steps, labels=labels)

    chain, _ = build()
    plan = _draw_plan(chain)
    example = [zeros_like_draw(entry["distribution"], entry["shape"], target)
               for entry in plan]
    _warm(chain, example[:len(chain.start_draws())])
    program = torch.export.export(_Sampler(build), tuple(example))
    program.example_inputs = None  # else saved with the program: 196 MB of zeros at 1,000 steps
    out = program.graph_module.graph.find_nodes(op="output")[0].args[0][0].meta["val"]
    return ExportedSampler(program, plan, target.type, list(out.shape),
                           str(out.dtype).replace("torch.", ""))


def save_artifact(exported: ExportedSampler, path: Path, meta: Optional[dict] = None) -> dict:
    """Save ``exported`` to ``path`` with ``torch.export.save`` and a ``<path>.json``
    sidecar: the format, the torch version, the device, the output's shape and dtype, the
    draw plan, the file's sha256 and size, and ``meta`` (the provenance keys)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported.program, str(path))
    blob = path.read_bytes()
    sidecar = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "device": exported.device,
        "output_shape": exported.output_shape,
        "output_dtype": exported.output_dtype,
        "draw_plan": exported.draw_plan,
        "sha256": hashlib.sha256(blob).hexdigest(),
        "size_bytes": len(blob),
        **(meta or {}),
    }
    with open(f"{path}.json", "w") as f:
        json.dump(sidecar, f, indent=2)
    return sidecar


def load_artifact(path: Path, device: Optional[str] = None) -> ServingArtifact:
    """Load a frozen sampler saved by ``save_artifact``: the sidecar's sha256 is checked,
    and the artifact runs only on the device it was exported for (``device``, when
    given, must be it). Imports the kernels' ops module, and no model code."""
    path = Path(path)
    blob = path.read_bytes()
    with open(f"{path}.json") as f:
        meta = json.load(f)
    digest = hashlib.sha256(blob).hexdigest()
    if meta.get("sha256") != digest:
        raise ValueError(
            f"artifact {path} sha256 mismatch: sidecar says {meta.get('sha256')}, "
            f"blob is {digest}"
        )
    exported_on = torch.device(meta["device"])
    target = torch.device(device) if device is not None else exported_on
    if target.type != exported_on.type:
        raise ValueError(
            f"artifact {path} was exported for {exported_on.type} and cannot run on "
            f"{target.type}: export it again on {target.type}"
        )
    target = resolve_device(target)
    register_ops()
    program = torch.export.load(str(path))
    return ServingArtifact(program, meta, target, program.module())
