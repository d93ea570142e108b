"""Paged KV-cache attention for serving decode (counterpart of
paddle_tpu/ops/paged_attention.py).

`paged_attention` routes one decode step's attention by its ``impl``
argument, or ``FLAGS_paged_impl`` when none is given: "intree" (the
default) to the v2 kernel `ops.paged.paged_decode_attention_v2`,
"intree_v1" to the per-page v1 kernel, and "reference" to the gather
composite `paged_attention_reference`. On CPU tensors a shape
`paged_kernel_eligible` refuses also takes the composite, as the JAX
router does; on the card it goes to the kernel wrapper, which raises:
there is no fallback to plain PyTorch there. ``route_counts`` counts the
routes taken (``paged_intree``, ``paged_intree_v1``,
``paged_reference``).

`append_to_cache` writes one decode step's K/V rows into the pools.

The JAX module's KV-utilization gauge (``pt_serving_kv_page_utilization``)
belongs to the observability layer, which is not ported yet (ROADMAP.md
queue A item 9).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..flags import PAGED_IMPLS, flag
from .paged import (paged_decode_attention, paged_decode_attention_v2,
                    paged_kernel_eligible)

__all__ = ["paged_attention", "paged_attention_reference", "append_to_cache",
           "route_counts", "reset_route_counts"]

#: calls of `paged_attention` by route
route_counts: Dict[str, int] = {"paged_intree": 0, "paged_intree_v1": 0,
                                "paged_reference": 0}


def reset_route_counts() -> None:
    for k in route_counts:
        route_counts[k] = 0


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices,
                              scale: Optional[float] = None):
    """Decode-step attention against a paged KV cache, the JAX
    reference's way: gather each sequence's pages, repeat K/V for GQA,
    f32 softmax over the first lengths[b] positions (masked at -1e30, so
    a length-0 row gives the mean of V).

    q [B, H, D]; k/v_pages [KV, total_pages, page_size, D]; lengths [B];
    page_indices [B, pages_per_seq]."""
    B, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    KV, total, psz, _ = k_pages.shape
    nj = page_indices.shape[1]
    rep = H // KV
    tabs = page_indices.to(q.device, torch.long).clamp(0, total - 1)
    ks = k_pages[:, tabs].permute(1, 0, 2, 3, 4).reshape(B, KV, nj * psz, D)
    vs = v_pages[:, tabs].permute(1, 0, 2, 3, 4).reshape(B, KV, nj * psz, D)
    if rep > 1:
        ks = ks.repeat_interleave(rep, dim=1)
        vs = vs.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), ks.float()) * scale
    pos = torch.arange(nj * psz, device=q.device)
    mask = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vs.float()).to(q.dtype)


def paged_attention(q, k_pages, v_pages, lengths, page_indices,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None):
    """Routing paged decode attention (see the module docstring). `impl`
    is a FLAGS_paged_impl value the caller pinned (the engine passes its
    own); None reads the flag."""
    if impl is None:
        impl = flag("FLAGS_paged_impl")
    elif impl not in PAGED_IMPLS:
        raise ValueError(f"paged_attention: impl {impl!r}, not one of "
                         f"{PAGED_IMPLS}")
    H, D = q.shape[1], q.shape[2]
    KV, psz = k_pages.shape[0], k_pages.shape[2]
    if impl == "reference" or (q.device.type == "cpu"
                               and not paged_kernel_eligible(
                                   H, KV, D, psz, q.element_size())):
        route_counts["paged_reference"] += 1
        return paged_attention_reference(q, k_pages, v_pages, lengths,
                                         page_indices, scale)
    if impl == "intree":
        route_counts["paged_intree"] += 1
        return paged_decode_attention_v2(q, k_pages, v_pages, lengths,
                                         page_indices, scale)
    route_counts["paged_intree_v1"] += 1
    return paged_decode_attention(q, k_pages, v_pages, lengths,
                                  page_indices, scale)


def append_to_cache(k_pages, v_pages, k_new, v_new, lengths, page_indices):
    """Write one decode step's K/V rows into the paged cache IN PLACE
    (the JAX function returned updated copies): row b goes to page
    page_indices[b, lengths[b] // page_size] (the column clamped to the
    table, as JAX's gather clamps) at offset lengths[b] % page_size.

    k_new/v_new: [B, KV, D]; returns (k_pages, v_pages, lengths + 1),
    the first two being the pools given.

    Idle engine slots all write the trash page 0 at offset 0, so those
    indices repeat; which row a CUDA ``index_put_`` keeps there is
    unspecified (JAX's sequential scan keeps the last). That is harmless
    only because page 0 is trash that no live sequence reads."""
    psz = k_pages.shape[2]
    B = k_new.shape[0]
    nj = page_indices.shape[1]
    lens = lengths.to(k_pages.device, torch.long)
    col = (lens // psz).clamp(0, nj - 1)
    page_of = page_indices.to(k_pages.device, torch.long)[
        torch.arange(B, device=k_pages.device), col]
    off = lens % psz
    k_pages[:, page_of, off] = k_new.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, page_of, off] = v_new.transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages, lengths + 1
