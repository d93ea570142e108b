"""Functional layers of the training path (counterpart of
paddle_tpu/nn/functional): plain PyTorch in the JAX package's op order,
differentiable by autograd. No kernel of the JAX package sits behind
these two: its `rms_norm` and `swiglu` are array code there too."""

from __future__ import annotations

import torch
from torch.nn import functional as F

__all__ = ["rms_norm", "swiglu"]


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """Normalize in f32, cast back to x's dtype, then multiply by the
    weight in that dtype (a bf16 row times a bf16 weight rounds once more
    than the serving kernel `ops.fused_rms_norm`, which multiplies in f32
    before its one cast)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = (x32 * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def swiglu(x, y=None):
    """silu(x) * y; with y None, x splits in half along its last axis
    into (gate, up)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y
