"""Linear and Embedding (counterpart of paddle_tpu/nn/layer/common.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """Paddle layout: weight ``[in_features, out_features]``, y = x @ W + b.
    The weight draws from Xavier normal (std sqrt(2 / (in + out))) and the
    bias, when ``bias_attr`` is not False, starts at zero — the JAX
    package's defaults."""

    def __init__(self, in_features: int, out_features: int,
                 bias_attr=None, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=dev, dtype=dtype).normal_(
                0.0, std, generator=generator))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_features, device=dev, dtype=dtype))

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    """Lookup table ``[num_embeddings, embedding_dim]`` drawn from
    N(0, 1)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device),
            dtype=dtype).normal_(0.0, 1.0, generator=generator))

    def forward(self, ids):
        return nn.functional.embedding(ids, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
