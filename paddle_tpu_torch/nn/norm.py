"""RMSNorm (counterpart of paddle_tpu/nn/layer/norm.py)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .functional import rms_norm

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """weight ``[hidden_size]`` starting at ones; forward is
    ``functional.rms_norm`` (the JAX layer's op order, differentiable).
    The serving engine reads the weight and calls the
    ``ops.fused_rms_norm`` kernel itself; that kernel has no backward."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
