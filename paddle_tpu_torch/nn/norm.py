"""LayerNorm and RMSNorm (counterpart of paddle_tpu/nn/layer/norm.py)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .functional import layer_norm, rms_norm

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """weight (ones) and bias (zeros) of shape ``normalized_shape``, each
    left out when its ``*_attr`` is False; forward is
    ``functional.layer_norm`` (the JAX layer's op order,
    differentiable). The serving engine reads the parameters and calls
    the ``ops.fused_layer_norm`` kernel itself; that kernel has no
    backward."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        dev = resolve_device(device)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, device=dev, dtype=dtype))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, device=dev, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self.normalized_shape}, "
                f"epsilon={self.epsilon}")


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
