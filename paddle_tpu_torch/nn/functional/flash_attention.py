"""paddle.nn.functional.flash_attention (counterpart of
paddle_tpu/nn/functional/flash_attention.py).

Every entry point routes through ``paddle_tpu_torch.ops.flash_attention``:
the flash kernel (segment ids for varlen), the FlashMask kernel, or the
f32-softmax composite where the JAX package takes it. The ``flash_*``
names return ``(out, None)``: the softmax is never materialized.
"""

from __future__ import annotations

from ...ops.flash_attention import (flash_attention, flash_attn_unpadded,
                                    flashmask_attention, sdpa,
                                    sdpa_segmented)
from . import scaled_dot_product_attention

__all__ = ["flash_attention", "flash_attn_unpadded", "flash_attn_qkvpacked",
           "flashmask_attention", "scaled_dot_product_attention", "sdpa",
           "sdpa_segmented"]


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, name=None):
    """[B, S, 3, H, D] packed q / k / v -> `flash_attention` on the
    unpacked views."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax)
