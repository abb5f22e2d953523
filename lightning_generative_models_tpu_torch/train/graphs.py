"""CUDA graphs of k training steps: the port's ``--unroll_steps k`` on the card.

The JAX trainer fuses k optimisation steps into one XLA program, compiled once per tuple
of the steps' host-side branches (the EMA flags, ``trainer.py:160-201``). Here the k
steps are one CUDA graph, captured once per tuple of the model's ``host_branch`` values
over the k steps (DDPM: the EMA's decays; WGAN: the D/G alternation; the consistency
model: its curriculum's interval count too; VQGAN: whether its discriminator is on),
every graph in one shared memory pool (they never run at once). A dispatch:

- the first of a tuple runs its k steps eagerly on the capture stream: the warm-up that
  builds the kernels, loads the libraries, lets cuDNN and cuBLAS pick their algorithms,
  and makes the optimizer's state and the modules' caches;
- the second captures the k steps on fresh static batch buffers, then replays. A capture
  that fails (a step that waits on the device) raises, naming the line that synchronizes
  (the k steps rerun eagerly with host syncs made errors);
- every later one copies its k stacked batches into those buffers, re-seeds the k
  registered generators and replays.

Randomness: slot i's generator is registered with every graph and re-seeded before each
replay with the seed of step ``global_step + i``, so a replay draws what k eager steps on
fresh generators draw. Host state: a capture runs the steps' Python once, so the model's
Python scalars are restored after it, and a replay advances the model's ``step`` by k; a
capture that changes any other scalar, or rebinds a state tensor (a parameter, buffer,
optimizer state or tensor attribute: the graph would keep writing the old one), raises.
Launch counters: what the kernel wrappers count while a graph is captured (no kernel
runs then) is taken back and added at every replay instead.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch import nn

from lightning_generative_models_tpu_torch.ops.common import launch_counters, launch_counts

Batch = Dict[str, torch.Tensor]
StepFn = Callable[[Batch, torch.Generator], Dict[str, torch.Tensor]]


def host_scalars(model: Any) -> Dict[str, Any]:
    """The model's Python scalar attributes (its step counter among them)."""
    return {k: v for k, v in vars(model).items() if isinstance(v, (bool, int, float, str))}


def state_tensors(model: Any) -> Dict[str, torch.Tensor]:
    """{name: tensor} of everything a train step may update: every parameter and buffer
    of the model's modules, every optimizer's state, and its tensor attributes."""
    out: Dict[str, torch.Tensor] = {}
    names = {id(p): f"{attr}.{n}" for attr, value in vars(model).items()
             if isinstance(value, nn.Module) for n, p in value.named_parameters()}

    def optimizer(name: str, opt: torch.optim.Optimizer) -> None:
        for i, p in enumerate(q for g in opt.param_groups for q in g["params"]):
            for key, value in opt.state.get(p, {}).items():
                if isinstance(value, torch.Tensor):
                    out[f"{name}[{names.get(id(p), i)}].{key}"] = value

    for attr, value in vars(model).items():
        if isinstance(value, nn.Module):
            for name, t in list(value.named_parameters()) + list(value.named_buffers()):
                out[f"{attr}.{name}"] = t
        elif isinstance(value, torch.optim.Optimizer):
            optimizer(attr, value)
        elif isinstance(value, dict):
            for key, item in value.items():
                if isinstance(item, torch.optim.Optimizer):
                    optimizer(f"{attr}[{key}]", item)
        elif isinstance(value, torch.Tensor):
            out[attr] = value
    return out


def unroll_key(model: Any, k: int) -> tuple:
    """The host-side branches of the model's next k steps (``host_branch``)."""
    return tuple(model.host_branch(model.step + i) for i in range(k))


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    static: Batch
    metrics: Dict[str, torch.Tensor]
    launches: Dict[str, int]


class StepGraphs:
    """k steps of ``step_fn(batch, generator)`` on ``model`` as CUDA graphs (module doc).
    ``__call__(stacked, seeds)`` runs one dispatch on a batch dict of [k, B, ...] device
    tensors with the k steps' generator seeds and returns the last step's metrics.
    ``graphs`` holds the captured graphs by branch tuple."""

    def __init__(self, model: Any, k: int, step_fn: StepFn, device: torch.device):
        self.model, self.k, self.step_fn, self.device = model, k, step_fn, device
        self.generators = [torch.Generator(device=device) for _ in range(k)]
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.warmed: set = set()
        self.graphs: Dict[tuple, _Captured] = {}

    def __call__(self, stacked: Batch, seeds: Sequence[int]) -> Dict[str, torch.Tensor]:
        key = unroll_key(self.model, self.k)
        if key not in self.warmed:
            metrics = self._eager(stacked, seeds)
            self.warmed.add(key)
            return metrics
        entry = self.graphs.get(key) or self._capture(key, stacked)
        for name, buf in entry.static.items():
            buf.copy_(stacked[name])
        for generator, seed in zip(self.generators, seeds):
            generator.manual_seed(int(seed))
        entry.graph.replay()
        self.model.step += self.k
        for name, fn in launch_counters().items():
            fn.launches += entry.launches[name]
        return entry.metrics

    def _steps(self, stacked: Batch, generators: List[torch.Generator]):
        metrics = None
        for i, generator in enumerate(generators):
            metrics = self.step_fn({name: v[i] for name, v in stacked.items()}, generator)
        return metrics

    def _eager(self, stacked: Batch, seeds: Sequence[int]) -> Dict[str, torch.Tensor]:
        generators = [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            metrics = self._steps(stacked, generators)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        return metrics

    def _where_it_syncs(self, stacked: Batch) -> str:
        """The k steps once more, eagerly, with host syncs made errors: the package's
        innermost line that raises, or what was raised."""
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            self._steps(stacked, [torch.Generator(device=self.device)] * self.k)
        except RuntimeError as e:
            frames = [f for f in traceback.extract_tb(e.__traceback__)
                      if "lightning_generative_models_tpu_torch" in f.filename]
            where = f" at {frames[-1].filename}:{frames[-1].lineno}" if frames else ""
            return f"{e}{where}"
        finally:
            torch.cuda.set_sync_debug_mode(before)
        return "no synchronizing call found"

    def _capture(self, key: tuple, stacked: Batch) -> _Captured:
        name = type(self.model).__name__
        static = {n: torch.empty_like(v) for n, v in stacked.items()}
        scalars = host_scalars(self.model)
        tensors = {n: (id(t), t.data_ptr()) for n, t in state_tensors(self.model).items()}
        counts = launch_counts()
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        torch.cuda.current_stream(self.device).synchronize()
        try:
            # thread_local: the batch prefetcher's thread pins host memory meanwhile.
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                metrics = self._steps(static, self.generators)
        except RuntimeError as e:
            vars(self.model).update(scalars)
            raise RuntimeError(
                f"{name}'s train step cannot be captured in a CUDA graph ({e}): "
                f"{self._where_it_syncs(stacked)}; see ROADMAP.md, Queue 3") from e
        finally:
            after = host_scalars(self.model)
            vars(self.model).update(scalars)
            now = launch_counts()
            captured = {n: now[n] - counts[n] for n in counts}
            for n, fn in launch_counters().items():
                fn.launches = counts[n]
        expected = {**scalars, "step": scalars["step"] + self.k}
        changed = sorted(n for n in set(after) | set(expected)
                         if after.get(n) != expected.get(n))
        if changed:
            raise RuntimeError(f"{name}'s train step changes host state a CUDA graph cannot "
                               f"replay: {changed}; see ROADMAP.md, Queue 3")
        rebound = sorted(n for n, t in state_tensors(self.model).items()
                         if tensors.get(n) != (id(t), t.data_ptr()))
        if rebound:
            raise RuntimeError(f"{name}'s train step rebinds state tensors, which a CUDA "
                               f"graph would not update: {rebound[:8]}; see ROADMAP.md, "
                               "Queue 3")
        entry = _Captured(graph, static, metrics, captured)
        self.graphs[key] = entry
        return entry
