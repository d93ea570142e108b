"""Functional layers of the training path (counterpart of
paddle_tpu/nn/functional): plain PyTorch in the JAX package's op order,
differentiable by autograd. No kernel of the JAX package sits behind
these: its `rms_norm`, `layer_norm`, `gelu` and `swiglu` are array code
there too (the serving engine calls the ``ops.fused_layer_norm`` kernel
itself)."""

from __future__ import annotations

import torch
from torch.nn import functional as F

__all__ = ["rms_norm", "layer_norm", "gelu", "swiglu"]


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """Normalize in f32, cast back to x's dtype, then multiply by the
    weight in that dtype (a bf16 row times a bf16 weight rounds once more
    than the serving kernel `ops.fused_rms_norm`, which multiplies in f32
    before its one cast)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = (x32 * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Normalize over the trailing ``normalized_shape`` axes in x's own
    dtype, as the JAX package does (the mean, then the centred variance
    mean((x - mean)^2)), then multiply by the weight and add the bias."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    mean = x.mean(axes, keepdim=True)
    var = ((x - mean) * (x - mean)).mean(axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x, approximate: bool = False):
    """GELU: exact (erf) or, with ``approximate``, the tanh form in
    jax.nn.gelu(approximate=True)'s op order."""
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(0.7978845608028654
                                      * (x + 0.044715 * (x * x * x))))
        return x * cdf
    return F.gelu(x)


def swiglu(x, y=None):
    """silu(x) * y; with y None, x splits in half along its last axis
    into (gate, up)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y
