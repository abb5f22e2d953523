"""The random draws a sampler makes, as data: what a serving artifact's draw plan records.

A ``Draw`` names one tensor a sampler draws from its ``torch.Generator``: its shape and
its distribution. ``make_draw`` makes it with one generator call (none for ``zeros``),
the call the live sampler makes, so that a plan drawn in the live sampler's order
reproduces its draws:

- ``normal``: ``torch.randn``;
- ``uniform``: ``torch.rand``, in [0, 1);
- ``randint``: ``torch.randint`` in [0, ``high``), int64;
- ``gumbel``: ``-log(-log(max(u, tiny)))`` of one ``torch.rand`` u (the Gumbel-max
  pick ``argmax(logits + g)`` is ``jax.random.categorical``'s);
- ``zeros``: nothing drawn (a sampler that starts from zeros).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

DISTRIBUTIONS = ("normal", "uniform", "randint", "gumbel", "zeros")


class Draw(NamedTuple):
    """One tensor of a draw plan: its name, shape and distribution (``high``: the
    exclusive bound of ``randint``)."""

    name: str
    shape: tuple
    distribution: str = "normal"
    high: Optional[int] = None


def make_draw(distribution: str, shape, generator: Optional[torch.Generator], device,
              high: Optional[int] = None) -> torch.Tensor:
    """A tensor of ``distribution`` from one call on ``generator`` (module doc)."""
    shape = tuple(shape)
    if distribution == "normal":
        return torch.randn(shape, generator=generator, device=device)
    if distribution == "uniform":
        return torch.rand(shape, generator=generator, device=device)
    if distribution == "randint":
        return torch.randint(0, int(high), shape, generator=generator, device=device)
    if distribution == "gumbel":
        u = torch.rand(shape, generator=generator, device=device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    if distribution == "zeros":
        return torch.zeros(shape, device=device)
    raise ValueError(f"unknown distribution {distribution!r} in the draw plan "
                     f"(known: {', '.join(DISTRIBUTIONS)})")


def zeros_like_draw(distribution: str, shape, device) -> torch.Tensor:
    """Zeros of the dtype ``make_draw`` gives ``distribution``: an example input."""
    dtype = torch.long if distribution == "randint" else torch.float32
    return torch.zeros(tuple(shape), dtype=dtype, device=device)
