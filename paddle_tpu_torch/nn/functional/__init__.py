"""Functional layers of the training path (counterpart of
paddle_tpu/nn/functional): plain PyTorch in the JAX package's op order,
differentiable by autograd. No kernel of the JAX package sits behind
these: its `rms_norm`, `layer_norm`, `gelu`, `swiglu`, `linear`, `relu`
and `dropout` are array code there too (the serving engine calls the
``ops.fused_layer_norm`` kernel itself).

`scaled_dot_product_attention` routes through ``ops.flash_attention.sdpa``
(the flash kernel where its gate holds); the submodule
``flash_attention`` holds Paddle's ``paddle.nn.functional.flash_attention``
namespace (flash_attention, flash_attn_unpadded, flash_attn_qkvpacked,
flashmask_attention, ...)."""

from __future__ import annotations

import torch
from torch.nn import functional as F

__all__ = ["rms_norm", "layer_norm", "gelu", "swiglu", "relu", "linear",
           "dropout", "scaled_dot_product_attention"]

_DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


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


def relu(x, name=None):
    return torch.relu(x)


def linear(x, weight, bias=None, name=None):
    """Paddle layout: weight [in_features, out_features], x @ weight +
    bias."""
    out = x @ weight
    return out if bias is None else out + bias


def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None, name=None):
    """Paddle's dropout: in training each element is kept with
    probability 1 - p (drawn from `generator` on x's device) and scaled
    by 1 / (1 - p) under "upscale_in_train", left as it is under
    "downscale_in_infer", which instead scales by (1 - p) outside
    training. The JAX package's random stream is not reproduced."""
    if mode not in _DROPOUT_MODES:
        raise ValueError(f"dropout mode must be one of {_DROPOUT_MODES}, "
                         f"got {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """paddle.nn.functional.scaled_dot_product_attention on [B, S, H, D]:
    ``ops.flash_attention.sdpa`` (the flash kernel, a boolean key-padding
    mask through its segment ids, any other mask or dropout the
    composite); dropout only in training."""
    # imported here: ops imports this module (megadecode's gelu)
    from ...ops import flash_attention as _fa
    return _fa.sdpa(query, key, value, mask=attn_mask, causal=is_causal,
                    dropout_p=dropout_p if training else 0.0)
