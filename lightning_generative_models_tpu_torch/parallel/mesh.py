"""The device mesh over torch.distributed ranks, batch placement and the strategies'
layouts.

Counterpart of ``lightning_generative_models_tpu/parallel/mesh.py``. JAX states a layout
per leaf and GSPMD inserts the collectives; a step on N devices is then one program
on the global batch. Here every rank runs its own step, and each strategy earns the
single-device step on the global batch explicitly:

- ``initialize_distributed`` joins ``torchrun``'s process group (NCCL for CUDA, gloo
  when the caller asks for the CPU or for gloo) and returns the rank's device
  (``cuda:LOCAL_RANK``);
- ``Mesh`` lays the ranks out on named axes ``data``, ``model`` and ``stage``
  (row-major, as ``create_mesh``'s reshape of the device list) with one process group
  per axis line; ``set_mesh`` makes it the ambient mesh that the models read, as
  ``jax.set_mesh`` does. Without a process group (one process) every group is None and
  every collective the identity;
- batches: every rank builds the identical seeded global batch and keeps its data
  rank's rows ``[p B/n, (p+1) B/n)`` (``process_local_slice``, on axis 1 for the stacked
  batches of ``--unroll_steps``); ``global_draws`` makes a step's per-example draws
  those of the global batch, this rank's rows of them; ``to_host`` gathers the rows;
- gradients: the optimizers (``train/state.py``) average them over the data ranks
  (``grads_for_update``), one all-reduce per dtype;
- ``fsdp``: every leaf of at least ``FSDP_MIN_SIZE`` elements whose dim 0 the data ranks
  divide (the working weights and the EMA weights alike) holds this rank's dim-0 shard,
  as do its Adam moments; reading the module's attribute all-gathers the whole leaf (a
  ``torch.nn.utils.parametrize`` parametrization, ``_Shard``), whose backward
  reduce-scatters the gradient onto the shard, so the optimizer and the EMA update the
  shards;
- ``tp``: Megatron's rules by module name (``qkv``/``fc1`` column-parallel, ``proj``/
  ``fc2`` row-parallel, the MoE's ``wi``/``wo``/``bi``/``bo`` on dim 0) slice the DiT's
  weights, its EMA copy and Adam's moments over the ``model`` axis; the blocks place
  the collectives (``models/diffusion/dit.py``, ``models/modules/moe.py``);
- ``pp``: each ``stage`` rank runs its pipeline stage (``models/diffusion/pipeline.py``)
  and holds only that stage's weights, EMA weights and moments: the other stages' are
  released (0-element tensors) once the model is drawn or restored whole;
- ``gathered(model)``: the whole state on every rank for as long as a checkpoint is
  written (full tensors, the single-device format), the rank's layout again after.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize
from torch.overrides import TorchFunctionMode

from lightning_generative_models_tpu_torch.parallel import collectives as C

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"

#: FSDP keeps leaves below this many elements replicated (JAX ``fsdp_sharding``).
FSDP_MIN_SIZE = 2**16
#: Megatron's rules by module name (JAX ``_TP_COLUMN``, ``_TP_ROW``, ``_TP_EXPERT``).
TP_COLUMN = ("qkv", "fc1")
TP_ROW = ("proj", "fc2")
TP_EXPERT = ("wi", "wo", "bi", "bo")


def initialize_distributed(device: str = "cuda", backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> torch.device:
    """Join the process group that ``torchrun`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and return this
    rank's device; without ``WORLD_SIZE`` there is one process and no group. The backend
    is NCCL for ``device="cuda"`` and gloo for the CPU unless ``backend`` names one; a
    CUDA rank runs on ``cuda:LOCAL_RANK`` (gloo ranks may share a card: local rank modulo
    the card count). A rank whose collective fails raises, and the run exits non-zero."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA GPU is available; "
                               "pass device='cpu' to run on the CPU")
        count = torch.cuda.device_count()
        if local >= count and backend == "nccl":
            raise RuntimeError(f"local rank {local} has no card of its own ({count} "
                               "visible): NCCL takes one card a rank")
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s),
                                **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that writes logs, images and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class Mesh:
    """The ranks on named axes. ``shape`` defaults to all ranks on the first axis;
    ``group(axis)`` is this rank's process group along ``axis`` (None without a process
    group), ``index(axis)`` its coordinate there. ``fsdp`` marks the ``fsdp`` strategy's
    layout (set by ``shard_model``)."""

    def __init__(self, axis_names: Sequence[str] = (DATA_AXIS,),
                 shape: Optional[Sequence[int]] = None):
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.axis_names = tuple(axis_names)
        if shape is None:
            shape = (world,) + (1,) * (len(self.axis_names) - 1)
        if len(shape) != len(self.axis_names) or math.prod(shape) != world:
            raise ValueError(f"mesh shape {tuple(shape)} over axes {self.axis_names} does "
                             f"not hold the {world} ranks")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        grid = np.arange(world).reshape(tuple(shape))
        coords = np.unravel_index(self.rank, tuple(shape))
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(self.axis_names, coords)}
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for i, axis in enumerate(self.axis_names):
            self._groups[axis] = None
            if not dist.is_initialized():
                continue
            # Every rank creates every line's group, in the same order.
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]).tolist():
                group = dist.new_group(line)
                if self.rank in line:
                    self._groups[axis] = group
        # Under fsdp: (module, leaf name) of every sharded leaf, and their parameters.
        self.fsdp_leaves: List[Tuple[nn.Module, str]] = []
        self.fsdp_params: set = set()
        self.tp_dims: Dict[nn.Parameter, int] = {}
        # Under pp: the whole shape of every parameter of another rank's stage.
        self.released: Dict[nn.Parameter, torch.Size] = {}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self._groups.get(axis)


def create_mesh(axis_names: Sequence[str] = (DATA_AXIS,),
                shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over every rank (JAX ``create_mesh``): all on ``data`` by default."""
    return Mesh(axis_names, shape)


def strategy_mesh(strategy: str, tp_size: int = 0, pp_size: int = 0) -> Mesh:
    """The trainer's mesh for a strategy (JAX ``Trainer.__init__``): ``tp`` a
    (data, model) mesh with ``tp_size`` ranks on ``model`` (0: all), ``pp`` a (data,
    stage) mesh with ``pp_size`` on ``stage`` (0: all), the others a data mesh."""
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    if strategy == "tp":
        tp_size = tp_size or n_dev
        if n_dev % tp_size:
            raise ValueError(f"tp_size {tp_size} does not divide {n_dev} devices")
        return create_mesh((DATA_AXIS, MODEL_AXIS), (n_dev // tp_size, tp_size))
    if strategy == "pp":
        pp_size = pp_size or n_dev
        if n_dev % pp_size:
            raise ValueError(f"pp_size {pp_size} does not divide {n_dev} devices")
        return create_mesh((DATA_AXIS, STAGE_AXIS), (n_dev // pp_size, pp_size))
    return create_mesh()


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the ambient mesh (None: one device)."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def group(axis: str) -> Optional[dist.ProcessGroup]:
    """The ambient mesh's group along ``axis`` (None: one device, or no such axis)."""
    return None if _MESH is None else _MESH.group(axis)


def data_size() -> int:
    return 1 if _MESH is None else _MESH.size(DATA_AXIS)


def data_index() -> int:
    return 0 if _MESH is None else _MESH.index(DATA_AXIS)


# -- batches -------------------------------------------------------------------------
def process_local_slice(x: np.ndarray, batch_axis: int = 0,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> np.ndarray:
    """This data rank's contiguous slice ``[p B/n, (p+1) B/n)`` of a global batch."""
    p = data_index() if process_index is None else process_index
    n = data_size() if process_count is None else process_count
    size = x.shape[batch_axis]
    if size % n != 0:
        raise ValueError(f"global batch {size} not divisible by {n} processes")
    per = size // n
    idx = [slice(None)] * x.ndim
    idx[batch_axis] = slice(p * per, (p + 1) * per)
    return x[tuple(idx)]


def local_rows(batch: Dict[str, Any], batch_axis: int = 0) -> Dict[str, Any]:
    """Every array of a batch cut to this data rank's rows (unchanged on one rank)."""
    if data_size() == 1:
        return batch
    return {k: process_local_slice(np.asarray(v), batch_axis) for k, v in batch.items()}


def local_batch_size(global_batch_size: int, mesh: Optional[Mesh] = None) -> int:
    """Per-rank batch size for a global batch on the data axis."""
    mesh = mesh if mesh is not None else _MESH
    n = 1 if mesh is None else mesh.size(DATA_AXIS)
    if global_batch_size % n != 0:
        raise ValueError(f"global batch size {global_batch_size} not divisible by "
                         f"{n} devices")
    return global_batch_size // n


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data ranks' rows of ``x`` concatenated in rank order, on the device."""
    return C.all_gather(x, group(DATA_AXIS), 0)


def to_host(x: torch.Tensor) -> np.ndarray:
    """``gather_rows(x)`` as host numpy (f32)."""
    return gather_rows(x).float().cpu().numpy()


@torch.no_grad()
def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (no gradient): logged means, BEGAN's
    balance."""
    g = group(DATA_AXIS)
    if g is None:
        return x
    return C.all_reduce_(x.detach().clone().contiguous(), g) / C.size(g)


def data_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks, differentiable (backward: the sum)."""
    return C.all_reduce_sum(x, group(DATA_AXIS))


_DRAWS = (torch.rand, torch.randn, torch.randint)


class _GlobalDraws(TorchFunctionMode):
    """See ``global_draws``."""

    def __init__(self, rows: int, n: int, index: int):
        super().__init__()
        self.rows, self.n, self.index = rows, n, index
        self.paused = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _DRAWS or kwargs.get("generator") is None or self.paused:
            return func(*args, **kwargs)
        shape = _draw_shape(func, args, kwargs)
        if not shape or shape[0] != self.rows:
            return func(*args, **kwargs)
        args, kwargs = _with_shape(func, args, kwargs, (self.rows * self.n, *shape[1:]))
        return func(*args, **kwargs).narrow(0, self.index * self.rows, self.rows)


def _draw_shape(func, args, kwargs) -> Optional[tuple]:
    """The shape of a ``torch.rand``/``randn``/``randint`` call as a tuple of ints (None
    when it is not given as one)."""
    if "size" in kwargs:
        return tuple(kwargs["size"])
    if func is torch.randint:
        last = args[-1] if args else None
        return tuple(last) if isinstance(last, (tuple, list, torch.Size)) else None
    if len(args) == 1 and isinstance(args[0], (tuple, list, torch.Size)):
        return tuple(args[0])
    if args and all(isinstance(a, int) for a in args):
        return tuple(args)
    return None


def _with_shape(func, args, kwargs, shape) -> Tuple[tuple, dict]:
    if "size" in kwargs:
        return args, {**kwargs, "size": shape}
    if func is torch.randint:
        return (*args[:-1], shape), kwargs
    return (shape,), kwargs


@contextlib.contextmanager
def global_draws(rows: int) -> Iterator[None]:
    """Inside, a ``torch.rand``/``randn``/``randint`` call with a ``generator`` whose
    leading dimension is ``rows`` (this rank's batch rows) draws the global batch's
    ``rows * data ranks`` and returns this data rank's rows of it: every rank seeds the
    same generator, so N ranks see the draws of one device on the global batch (the
    timesteps, the noise, the flips, the label drops, the GANs' z). A draw of another
    leading size (a scalar coin) is every rank's alike, and so is one made under
    ``replicated_draws``: a draw that is not per-example but may have ``rows`` rows
    (InfoGAN's interpolation ends [1, cont] when a rank samples one row) is made there.
    Not intercepted: ``randn_like``/``rand_like``, ``Tensor.normal_``/``uniform_`` and any
    draw without a generator; the port's steps and samplers make their per-example draws
    with ``torch.rand``/``randn``/``randint`` on a generator. Nothing changes on one data
    rank."""
    n = data_size()
    if n == 1:
        yield
        return
    with _GlobalDraws(rows, n, data_index()):
        yield


@contextlib.contextmanager
def replicated_draws() -> Iterator[None]:
    """Inside, draws are every rank's alike, also inside ``global_draws``."""
    mode = _active_draws()
    if mode is None:
        yield
        return
    was, mode.paused = mode.paused, True
    try:
        yield
    finally:
        mode.paused = was


def global_rows(n: int) -> int:
    """The global batch's row count for this rank's ``n`` rows inside
    ``global_draws(n)`` (``n`` elsewhere)."""
    mode = _active_draws()
    return n if mode is None or mode.rows != n else n * mode.n


def example_ids(n: int, device) -> torch.Tensor:
    """The global batch positions of this rank's ``n`` rows inside ``global_draws(n)``
    (``arange(n)`` on one rank): what a sampler cycles its class labels over."""
    ids = torch.arange(n, device=device)
    mode = _active_draws()
    return ids if mode is None or mode.rows != n else ids + mode.index * n


def _active_draws() -> Optional[_GlobalDraws]:
    from torch.overrides import _get_current_function_mode_stack

    for mode in reversed(_get_current_function_mode_stack()):
        if isinstance(mode, _GlobalDraws):
            return mode
    return None


def sample_rows(fn, n: int):
    """``fn(rows)`` for this data rank's ``n / ranks`` rows under ``global_draws``, its
    output's rows gathered over the data ranks: sampling sharded over the data axis,
    equal to ``fn(n)`` on one device (JAX ``data_shard``). With a batch the ranks do not
    divide, every rank runs ``fn(n)`` whole."""
    ranks = data_size()
    if ranks == 1 or n % ranks:
        return fn(n)
    rows = n // ranks
    with global_draws(rows):
        out = fn(rows)
    return gather_rows(out)


# -- gradients and the optimizer's update ---------------------------------------------------
def fsdp_dim(p: torch.Tensor, n: int) -> Optional[int]:
    """The dim an ``fsdp`` leaf is sharded on: 0 when it has ``FSDP_MIN_SIZE`` elements
    and its dim 0 divides by the ``n`` data ranks, else None (replicated)."""
    if n <= 1 or p.dim() == 0 or p.numel() < FSDP_MIN_SIZE or p.shape[0] % n:
        return None
    return 0


def grads_for_update(params: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients of ``params`` (their ``.grad``) averaged over the data ranks: one
    all-reduce per dtype; an ``fsdp`` shard's gradient comes reduce-scattered already
    (``_Shard``'s backward) and is only divided."""
    grads = [p.grad for p in params]
    g = group(DATA_AXIS)
    if g is None:
        return grads
    C.flat_all_reduce_([grad for p, grad in zip(params, grads)
                        if p not in _MESH.fsdp_params], g)
    torch._foreach_div_(grads, float(C.size(g)))
    return grads


class _Shard(nn.Module):
    """The ``fsdp`` parametrization of a leaf: the parameter holds this data rank's dim-0
    shard, and the module's attribute is the whole leaf, all-gathered at each read (its
    backward reduce-scatters the gradient, summed over the ranks, onto the shard)."""

    def __init__(self, group: Optional[dist.ProcessGroup]):
        super().__init__()
        self.group = group

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return C.gather_tokens(shard, self.group, 0)

    def right_inverse(self, whole: torch.Tensor) -> torch.Tensor:
        return C.chunk(whole, self.group, 0).clone()


# -- the strategies' layouts ------------------------------------------------------------
def _modules(model: Any) -> Dict[str, nn.Module]:
    return {k: v for k, v in vars(model).items() if isinstance(v, nn.Module)}


def _optimizers(model: Any) -> List[torch.optim.Optimizer]:
    found = []
    for value in vars(model).values():
        if isinstance(value, torch.optim.Optimizer):
            found.append(value)
        elif isinstance(value, dict):
            found += [v for v in value.values() if isinstance(v, torch.optim.Optimizer)]
    return found


def _moment_entries(model: Any, p: nn.Parameter):
    """(state dict, key) of every tensor an optimizer keeps for ``p`` in its shape."""
    for opt in _optimizers(model):
        state = opt.state.get(p, {})
        for key, value in state.items():
            if isinstance(value, torch.Tensor) and value.dim() == p.dim() and value.dim():
                yield state, key


def tp_rule(module_name: str, leaf: str, shape: Sequence[int]) -> Optional[int]:
    """The dim a leaf is sharded on over the ``model`` axis (JAX ``tp_sharding``), in the
    port's layout: Dense weights are [out, in], so a column-parallel ``qkv``/``fc1``
    shards the weight and bias on dim 0, a row-parallel ``proj``/``fc2`` the weight on dim
    1 (its bias stays whole), the MoE's expert-major leaves on dim 0; None: replicated."""
    mod = module_name.rsplit(".", 1)[-1]
    if mod in TP_COLUMN and leaf in ("weight", "bias"):
        return 0
    if mod in TP_ROW and leaf == "weight" and len(shape) == 2:
        return 1
    if mod == "moe" and leaf in TP_EXPERT and len(shape) >= 2:
        return 0
    return None


def _tp_leaves(model: Any, n: int):
    for mname, module in _modules(model).items():
        for name, sub in module.named_modules():
            for leaf, p in sub.named_parameters(recurse=False):
                dim = tp_rule(name, leaf, p.shape)
                if dim is None:
                    continue
                if p.shape[dim] % n:
                    path = "/".join(f"{mname}.{name}.{leaf}".split(".")[-4:])
                    raise ValueError(
                        f"tensor-parallel leaf {path} has dim {dim} of size "
                        f"{p.shape[dim]}, not divisible by the {n}-way model axis")
                yield sub, p, dim


def shard_model(model: Any, strategy: str, mesh: Mesh) -> None:
    """Lay the model's state out for ``strategy`` on ``mesh`` (after its weights are
    drawn or restored, whole): ``fsdp`` shards the large leaves of every module, EMA
    copies included, and their Adam moments on dim 0 (new moments start on the shard),
    ``tp`` slices the DiT's weights, EMA weights and
    moments over ``model`` and turns the blocks' collectives on, ``pp`` releases the
    other stage ranks' stages (weights, EMA weights, moments); the others keep the whole
    state. Makes ``mesh`` the ambient mesh."""
    set_mesh(mesh)
    if strategy == "fsdp":
        g = mesh.group(DATA_AXIS)
        n = C.size(g)
        for module in _modules(model).values():
            for sub in module.modules():
                for name, p in sub.named_parameters(recurse=False):
                    if fsdp_dim(p, n) is not None:
                        mesh.fsdp_leaves.append((sub, name))
                        mesh.fsdp_params.add(p)
        _shard_leaves(model, mesh)
    elif strategy == "tp":
        g = mesh.group(MODEL_AXIS)
        n, r = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
        for sub, p, dim in list(_tp_leaves(model, n)):
            mesh.tp_dims[p] = dim
            entries = list(_moment_entries(model, p))
            with torch.no_grad():
                p.data = p.data.chunk(n, dim)[r].clone()
            for state, key in entries:
                state[key] = state[key].chunk(n, dim)[r].clone()
        for module in _modules(model).values():
            for sub in module.modules():
                if hasattr(sub, "tensor_parallel"):
                    sub.tensor_parallel = True
    elif strategy == "pp" and mesh.size(STAGE_AXIS) > 1:
        for p in _other_stages(model, mesh):
            mesh.released[p] = p.shape
        _release(model, mesh)


@torch.no_grad()
def _shard_leaves(model: Any, mesh: Mesh) -> None:
    """Every ``fsdp`` leaf and its moments cut to this rank's dim-0 shard."""
    g = mesh.group(DATA_AXIS)
    for sub, name in mesh.fsdp_leaves:
        p = getattr(sub, name)
        for state, key in list(_moment_entries(model, p)):
            state[key] = C.chunk(state[key], g, 0).clone()
        parametrize.register_parametrization(sub, name, _Shard(g))


@torch.no_grad()
def _unshard_leaves(model: Any, mesh: Mesh) -> None:
    """Every ``fsdp`` leaf and its moments whole again (all-gathered)."""
    g = mesh.group(DATA_AXIS)
    for sub, name in mesh.fsdp_leaves:
        p = sub.parametrizations[name].original
        entries = list(_moment_entries(model, p))
        parametrize.remove_parametrizations(sub, name, leave_parametrized=True)
        for state, key in entries:
            state[key] = C.all_gather(state[key], g, 0)


def _stage_params(model: Any) -> Iterator[Tuple[int, nn.Parameter]]:
    """(stage index, parameter) of every pipeline stage of the model's modules."""
    for module in _modules(model).values():
        for sub in module.modules():
            for s, stage in enumerate(getattr(sub, "pipeline_stage_modules", ())):
                for p in stage.parameters():
                    yield s, p


def _other_stages(model: Any, mesh: Mesh) -> List[nn.Parameter]:
    own = mesh.index(STAGE_AXIS)
    return [p for s, p in _stage_params(model) if s != own]


@torch.no_grad()
def _release(model: Any, mesh: Mesh) -> None:
    """The released parameters and their moments as 0-element tensors."""
    for p in mesh.released:
        entries = list(_moment_entries(model, p))
        p.data = p.data.new_empty(0)
        for state, key in entries:
            state[key] = state[key].new_empty(0)


@contextlib.contextmanager
def gathered(model: Any) -> Iterator[None]:
    """Inside, every rank holds the model's whole state, as one device would (a
    collective: every rank enters): ``tp`` and ``fsdp`` leaves and their moments
    all-gathered, each pipeline stage's weights, EMA weights and moments
    broadcast from its stage's rank. After, the rank's layout again."""
    mesh = _MESH
    if mesh is None or not dist.is_initialized():
        yield
        return
    params, states = [], []  # (parameter, dim, group), (state, key, dim, group) to cut back
    with torch.no_grad():
        _unshard_leaves(model, mesh)
        g = mesh.group(MODEL_AXIS)
        for p, dim in mesh.tp_dims.items():
            states += [(state, key, dim, g) for state, key in _moment_entries(model, p)]
            params.append((p, dim, g))
        for state, key, dim, g in states:
            state[key] = C.all_gather(state[key], g, dim)
        for p, dim, g in params:
            p.data = C.all_gather(p.data, g, dim)
        _broadcast_stages(model, mesh)
    try:
        yield
    finally:
        with torch.no_grad():
            for state, key, dim, g in states:
                state[key] = C.chunk(state[key], g, dim)
            for p, dim, g in params:
                p.data = C.chunk(p.data, g, dim)
            _release(model, mesh)
        _shard_leaves(model, mesh)


def _broadcast_stages(model: Any, mesh: Mesh) -> None:
    """Each pipeline stage's parameters and moments from its stage's rank, into whole
    tensors where this rank released them."""
    g = mesh.group(STAGE_AXIS)
    if not mesh.released:
        return
    for s, p in _stage_params(model):
        entries = list(_moment_entries(model, p))
        if p in mesh.released:
            p.data = p.data.new_empty(mesh.released[p])
            for state, key in entries:
                state[key] = state[key].new_empty(mesh.released[p])
        C.broadcast_(p.data, s, g)
        for state, key in entries:
            C.broadcast_(state[key], s, g)


# -- checks ------------------------------------------------------------------------
def validate_tp(model: Any, mesh: Mesh) -> None:
    """Tensor parallelism requires a DiT backbone in the "h3d" packed-qkv layout with
    heads divisible by the model axis (JAX ``Trainer._validate_tp``, its texts)."""
    from lightning_generative_models_tpu_torch.models.diffusion.dit import DiT

    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(
            "strategy='tp' needs a mesh with a 'model' axis "
            f"(got axes {mesh.axis_names}); pass --tp_size"
        )
    tp = mesh.size(MODEL_AXIS)
    net = getattr(model, "unet", None)
    if not isinstance(net, DiT):
        raise ValueError(
            "strategy='tp' supports the DiT backbone only — set "
            "network='dit' in the model config"
        )
    if net.qkv_layout != "h3d":
        raise ValueError(
            "strategy='tp' requires qkv_layout='h3d' in the model config "
            "(per-head q,k,v packing, so channel shards are whole heads)"
        )
    if net.heads % tp:
        raise ValueError(
            f"DiT heads={net.heads} not divisible by the {tp}-way "
            "model axis"
        )
    if net.seq_parallel:
        tokens = (model.img_size // net.patch_size) ** 2
        if tokens % tp:
            raise ValueError(
                f"seq_parallel: {tokens} tokens "
                f"(img {model.img_size} / patch {net.patch_size}) "
                f"not divisible by the {tp}-way model axis"
            )
    if net.num_experts and net.num_experts % tp:
        raise ValueError(
            f"MoE num_experts={net.num_experts} not divisible by the "
            f"{tp}-way model axis (expert parallelism shards whole "
            "experts)"
        )


def validate_pp(model: Any, mesh: Mesh) -> None:
    """Pipeline parallelism requires a DiT backbone whose stage count matches the stage
    axis (JAX ``Trainer._validate_pp``, its texts)."""
    from lightning_generative_models_tpu_torch.models.diffusion.dit import DiT

    if STAGE_AXIS not in mesh.axis_names:
        raise ValueError(
            "strategy='pp' needs a mesh with a 'stage' axis "
            f"(got axes {mesh.axis_names}); pass --pp_size"
        )
    pp = mesh.size(STAGE_AXIS)
    net = getattr(model, "unet", None)
    if not isinstance(net, DiT):
        raise ValueError(
            "strategy='pp' supports the DiT backbone only — set "
            "network='dit' in the model config"
        )
    if net.pipeline_stages != pp:
        raise ValueError(
            f"model config pipeline_stages={net.pipeline_stages} does "
            f"not match the {pp}-way stage axis (set pipeline_stages "
            "== pp_size; 0 disables the pipeline schedule entirely)"
        )
