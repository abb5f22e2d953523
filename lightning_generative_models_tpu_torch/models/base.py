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

from typing import Dict, Tuple

import torch

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
