"""Pipeline parallelism (``--strategy pp``) for the DiT block stack: the GPipe schedule.

Counterpart of ``lightning_generative_models_tpu/models/diffusion/pipeline.py`` (Huang
et al. 2019, arXiv:1811.06965). The ``depth`` DiT blocks are ``S = pipeline_stages``
stages of ``depth / S`` blocks (``stages/{s}/block_{j}``: the JAX package stacks each
stage's leaves on a leading [S] axis, ``pipeline/stages/block_j/...``, which
``weights.py`` splits), and a batch of b rows is ``M = gcd(b, pipeline_microbatches or
S)`` microbatches (JAX's degrade for batches the count does not divide). Per-example the
output is the sequential stack's: no op in a block couples examples.

- Without a ``stage`` axis of more than one rank (one device, or ``--pp_size 1``) the
  schedule runs here: ``M + S - 1`` ticks, at each a new microbatch enters stage 0 and
  stage s takes what stage s - 1 emitted the tick before; the last stage's emissions,
  from tick S - 1 on, are the output. A stage with nothing to take (the fill and drain
  bubble) does no work, where the JAX package runs it on zeros and drops the result.
- Over ``S`` stage ranks each rank runs its own stage: it receives each microbatch's
  activation from the rank before, sends its output to the rank after (the GPipe order:
  rank s works on microbatch i while rank s + 1 works on i - 1), and the last stage's
  output is broadcast, so that the embedding, the conditioning and the head stay whole
  on every rank, as JAX replicates them. The backward runs the microbatches in reverse:
  each gradient comes from the rank after and goes to the rank before, the conditioning's
  gradient is summed over the stages, the tokens' comes from stage 0.

Each stage's activations are recomputed in the backward (``torch.utils.checkpoint`` on
one device, a recompute per microbatch over ranks): only the stage inputs are kept, as
JAX's remat of the stage body. ``einsum_attn`` (the default under the pipeline unless
``pp_fused_attn``) runs attention as plain PyTorch; otherwise kernels #3/#4, once per
microbatch and block (and once more in the recompute).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from lightning_generative_models_tpu_torch.parallel import collectives as C
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib


class Stage(nn.Module):
    """One pipeline stage: ``n_blocks`` sequential DiT blocks (no MoE)."""

    def __init__(self, n_blocks: int, hidden: int, heads: int, mlp_ratio: float,
                 dtype: torch.dtype, qkv_layout: str, einsum_attn: bool):
        super().__init__()
        from lightning_generative_models_tpu_torch.models.diffusion.dit import DiTBlock

        self.blocks = []
        for j in range(n_blocks):
            block = DiTBlock(hidden, heads, mlp_ratio, dtype=dtype, qkv_layout=qkv_layout,
                             einsum_attn=einsum_attn)
            self.add_module(f"block_{j}", block)
            self.blocks.append(block)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x, _ = block(x, c)
        return x


class PipelineBlocks(nn.Module):
    """The block stack as ``stages`` stages run by the GPipe schedule (module doc)."""

    def __init__(self, stages: int, microbatches: int, per_stage: int, hidden: int,
                 heads: int, mlp_ratio: float, dtype: torch.dtype, qkv_layout: str,
                 einsum_attn: bool):
        super().__init__()
        self.microbatches = microbatches
        self.stages = nn.ModuleList(
            Stage(per_stage, hidden, heads, mlp_ratio, dtype, qkv_layout, einsum_attn)
            for _ in range(stages))

    @property
    def pipeline_stage_modules(self) -> List[Stage]:
        """The stages, in order (``parallel/mesh.py:gathered`` reads them)."""
        return list(self.stages)

    def forward(self, tok: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """tok [b, n, hidden], c [b, hidden] -> [b, n, hidden]."""
        m = math.gcd(tok.shape[0], self.microbatches)
        g = mesh_lib.group(mesh_lib.STAGE_AXIS)
        if C.size(g) == 1:
            return _local_schedule(list(self.stages), tok, c, m)
        if C.size(g) != len(self.stages):
            raise ValueError(f"{len(self.stages)} pipeline stages on a {C.size(g)}-way "
                             "stage axis (set pipeline_stages == pp_size)")
        stage = self.stages[C.rank(g)]
        if not torch.is_grad_enabled():
            return _forward_ranks(stage, tok, c, m, g)[0]
        return _PipelineRanks.apply(tok, c, stage, m, g, *stage.parameters())


def _stage_call(stage: Stage, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The stage on one microbatch; under autograd its activations are recomputed in
    the backward."""
    if torch.is_grad_enabled():
        return checkpoint(stage, x, c, use_reentrant=False, preserve_rng_state=False)
    return stage(x, c)


def _local_schedule(stages: List[Stage], tok: torch.Tensor, c: torch.Tensor,
                    m: int) -> torch.Tensor:
    """The GPipe ticks with every stage on this device."""
    xs, cs = tok.chunk(m), c.chunk(m)
    emitted: List[Optional[tuple]] = [None] * len(stages)
    outs = []
    for t in range(m + len(stages) - 1):
        # Shift: microbatch t enters stage 0, stage s takes stage s - 1's last output.
        taken = [(xs[t], cs[t]) if t < m else None] + emitted[:-1]
        emitted = [None if inp is None else (_stage_call(stage, *inp), inp[1])
                   for stage, inp in zip(stages, taken)]
        if emitted[-1] is not None:
            outs.append(emitted[-1][0])
    return torch.cat(outs)


def _send(x: torch.Tensor, index: int, g) -> None:
    dist.send(x.contiguous(), dist.get_global_rank(g, index), group=g)


def _recv(like: torch.Tensor, index: int, g) -> torch.Tensor:
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    dist.recv(out, dist.get_global_rank(g, index), group=g)
    return out


def _forward_ranks(stage: Stage, tok: torch.Tensor, c: torch.Tensor, m: int, g):
    """This rank's stage over the microbatches, the last stage's output broadcast:
    (output [b, n, hidden], the stage's inputs)."""
    s, last = C.rank(g), C.size(g) - 1
    xs, cs = tok.chunk(m), c.chunk(m)
    ins, outs = [], []
    with torch.no_grad():
        for i in range(m):
            x = xs[i] if s == 0 else _recv(xs[i], s - 1, g)
            ins.append(x)
            y = stage(x, cs[i])
            if s < last:
                _send(y, s + 1, g)
            else:
                outs.append(y)
    out = torch.cat(outs) if s == last else torch.empty_like(
        tok, memory_format=torch.contiguous_format)
    return C.broadcast_(out, last, g), ins


class _PipelineRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tok, c, stage, m, g, *params):
        out, ins = _forward_ranks(stage, tok, c, m, g)
        ctx.stage, ctx.m, ctx.g = stage, m, g
        ctx.save_for_backward(c, *ins)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        c, *ins = ctx.saved_tensors
        stage, m, g = ctx.stage, ctx.m, ctx.g
        s, last = C.rank(g), C.size(g) - 1
        params = list(stage.parameters())
        gparams = [torch.zeros_like(p) for p in params]
        cs, gys = c.chunk(m), grad_out.contiguous().chunk(m)
        gcs: List[torch.Tensor] = [None] * m
        gxs: List[torch.Tensor] = [None] * m
        for i in reversed(range(m)):
            gy = gys[i] if s == last else _recv(ins[i], s + 1, g)
            with torch.enable_grad():
                x = ins[i].detach().requires_grad_()
                ci = cs[i].detach().requires_grad_()
                y = stage(x, ci)
                gx, gc, *gp = torch.autograd.grad(y, [x, ci, *params], gy,
                                                  allow_unused=True)
            pairs = [(a, b) for a, b in zip(gparams, gp) if b is not None]
            if pairs:
                torch._foreach_add_([a for a, _ in pairs], [b for _, b in pairs])
            gcs[i] = gc
            if s > 0:
                _send(gx, s - 1, g)
            else:
                gxs[i] = gx
        gtok = torch.cat(gxs) if s == 0 else torch.empty_like(
            grad_out, memory_format=torch.contiguous_format)
        C.broadcast_(gtok, 0, g)
        gc = C.all_reduce_(torch.cat(gcs).contiguous(), g)
        return (gtok, gc, None, None, None, *gparams)
