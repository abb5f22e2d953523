"""Residual stack of the VQ-VAE encoder and decoder, NHWC.

Counterpart of ``lightning_generative_models_tpu/models/modules/residual.py``: each
block is ReLU -> 3x3 conv (no bias) -> ReLU -> 1x1 conv (no bias) with a skip
connection; the stack applies a final ReLU. Submodules carry flax's auto-names
(``ResidualBlock_0``, ``Conv_1``), so a flax tree maps onto them path for path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.layers import Conv


class ResidualBlock(nn.Module):
    def __init__(self, hidden_dim: int, num_residual_hiddens: int):
        super().__init__()
        self.Conv_0 = Conv(hidden_dim, num_residual_hiddens, 3, bias=False)
        self.Conv_1 = Conv(num_residual_hiddens, hidden_dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.Conv_1(F.relu(self.Conv_0(F.relu(x))))


class ResidualStack(nn.Module):
    def __init__(self, hidden_dim: int, num_residual_layers: int, num_residual_hiddens: int):
        super().__init__()
        self.num_residual_layers = num_residual_layers
        for i in range(num_residual_layers):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(hidden_dim, num_residual_hiddens))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_residual_layers):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return F.relu(x)
