"""GenerativeModel: what the port's trainer, samplers and entry points need of a model.

Counterpart of ``lightning_generative_models_tpu/models/base.py``: images are NHWC in
[0, 1], and every source of randomness takes an explicit ``torch.Generator``. Where
the JAX protocol threads a ``TrainState`` through pure functions, a model here owns
its modules, optimizer and step counter and updates them in place:

- ``grad_step(batch, generator)`` -> ``(grads, metrics)``: gradient evaluation only;
  the model's weights and counters do not change;
- ``apply_grad_step(grads, metrics)`` -> ``metrics``: the optimizer step, the EMA and
  the step counter;
- ``train_step(batch, generator)`` = ``apply_grad_step(*grad_step(batch, generator))``;
- ``eval_step(batch, generator)`` -> ``metrics``;
- ``sample(generator, n)`` -> images in [0, 1];
- ``param_counts()`` -> ``{module name: parameter count}``, logged by the trainer;
- ``flax_layout()``: where a JAX ``TrainState`` goes (``weights.load_flax_train_state``);
  ``load_flax_weights(tree)``: the weights that ``generate --weights`` reads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.layers import init_params
from lightning_generative_models_tpu_torch.ops.common import resolve_device
from lightning_generative_models_tpu_torch.train.state import (
    apply_grads,
    count_params,
    make_adam,
)
from lightning_generative_models_tpu_torch.weights import load_flax_train_state

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


class GenerativeModel:
    """Base class for the port's models."""

    #: metric key the checkpointer monitors for the 'best' checkpoint
    monitor: str = "val_loss"
    #: False for models whose updates cannot be split into grad_step/apply_grad_step
    supports_grad_accum: bool = True

    def __init__(self, img_channels: int, img_size: int):
        self.img_channels = img_channels
        self.img_size = img_size

    @property
    def name(self) -> str:
        return type(self).__name__

    def image_shape(self) -> Tuple[int, int, int]:
        return (self.img_size, self.img_size, self.img_channels)

    # -- protocol ------------------------------------------------------------------
    def grad_step(self, batch: Batch, generator: torch.Generator):
        raise NotImplementedError

    def apply_grad_step(self, grads, metrics: Metrics) -> Metrics:
        raise NotImplementedError

    def train_step(self, batch: Batch, generator: torch.Generator) -> Metrics:
        return self.apply_grad_step(*self.grad_step(batch, generator))

    def eval_step(self, batch: Batch, generator: torch.Generator) -> Metrics:
        raise NotImplementedError

    def sample(self, generator: torch.Generator, num_samples: int) -> torch.Tensor:
        raise NotImplementedError

    def param_counts(self) -> Dict[str, int]:
        raise NotImplementedError

    def flax_layout(self) -> dict:
        raise NotImplementedError

    def load_flax_weights(self, tree) -> None:
        raise NotImplementedError

    @staticmethod
    def to_model_space(x01: torch.Tensor) -> torch.Tensor:
        """[0, 1] -> [-1, 1] (tanh output space)."""
        return x01 * 2.0 - 1.0

    @staticmethod
    def to_image_space(xm11: torch.Tensor) -> torch.Tensor:
        """[-1, 1] -> [0, 1], clipped."""
        return torch.clamp(xm11 * 0.5 + 0.5, 0.0, 1.0)

    @staticmethod
    def prefix_metrics(metrics: Metrics, mode: str) -> Metrics:
        return {f"{mode}_{k}": v for k, v in metrics.items()}

    def validation_grids(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Named sample grids logged at every validation: {name: images in [0, 1]}."""
        return {}

    def summary_spec(self) -> dict:
        """``{name: (module, example_args, kwargs)}`` of the per-layer tables the trainer
        logs at fit start (``utils/summary.py``); none by default."""
        return {}

    def host_branch(self, step: int):
        """What a train step at step count ``step`` (the model's ``step`` before it)
        decides on the host. A CUDA graph of k steps is captured once per tuple of these
        (``train/graphs.py``), as the JAX trainer compiles one program per tuple of EMA
        flags; None when the step takes no such branch."""
        return None

    def state_dict(self) -> dict:
        """Everything a checkpoint holds: weights, optimizer state, counters."""
        raise NotImplementedError

    def load_state_dict(self, state: dict) -> None:
        raise NotImplementedError


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in its stable form
    ``max(l, 0) - l t + log(1 + exp(-|l|))``, as the JAX package computes it."""
    return torch.mean(torch.clamp(logits, min=0.0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


class AdamModel(GenerativeModel):
    """A model whose weights are one module, ``net``, under one Adam: the JAX package's
    ``params={"model": ...}`` and ``opt_state={"model": ...}`` (the autoencoders, PixelCNN,
    NICE and Glow). It owns the device, the optimizer, the step counter, the checkpoint
    state and the flax layout; a subclass adds the math, ``grad_step`` among it."""

    def __init__(self, img_channels: int, img_size: int, net: nn.Module, lr: float,
                 b1: float, b2: float, weight_decay: float,
                 device: str | torch.device = "cuda"):
        super().__init__(img_channels, img_size)
        self.device = resolve_device(device)
        self.net = net
        self.lr, self.betas, self.weight_decay = lr, (b1, b2), weight_decay
        self.init_params()

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every weight from the CPU ``generator`` (seed 0 when omitted) and start a
        fresh optimizer at step 0."""
        init_params(self.net, generator)
        self.net.to(self.device)
        self.optimizer = make_adam(list(self.net.parameters()), self.lr, *self.betas,
                                   weight_decay=self.weight_decay)
        self.step = 0

    def param_counts(self) -> Dict[str, int]:
        return {"model": count_params(self.net)}

    def flax_layout(self) -> dict:
        return {"params": {"params/model": self.net},
                "adam": {"opt_state/model": (self.optimizer, {"": self.net})}}

    def load_flax_weights(self, tree) -> None:
        """``generate --weights``: a flattened JAX ``TrainState`` (its ``params``)."""
        load_flax_train_state(self, tree, optimizers=False)

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _grads(self, loss: torch.Tensor, metrics: Metrics):
        """(gradients of ``loss`` for every weight of ``net``, detached metrics)."""
        grads = torch.autograd.grad(loss, list(self.net.parameters()))
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def apply_grad_step(self, grads, metrics: Metrics) -> Metrics:
        apply_grads(self.optimizer, list(self.net.parameters()), grads)
        self.step += 1
        return self.prefix_metrics(metrics, "train")

    def train_step(self, batch: Batch, generator: Optional[torch.Generator] = None,
                   **draws) -> Metrics:
        return self.apply_grad_step(*self.grad_step(batch, generator, **draws))

    def state_dict(self) -> dict:
        return {"net": self.net.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.net.load_state_dict(state["net"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
