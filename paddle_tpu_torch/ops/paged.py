"""Paged decode attention kernels (counterpart of
paddle_tpu/ops/pallas_paged.py).

One decode step: q [B, H, D] (one query token per sequence) attends to
the first ``lengths[b]`` rows of a PAGED KV cache [KV, total_pages,
page_size, D] through a page table [B, pages_per_seq]; query head h
reads KV head h // (H // KV). Two kernels compute it, as in the JAX
package:

- `paged_decode_attention` (v1, the per-page variant): each block walks
  its sequence one page at a time, reading K/V rows straight from global
  memory;
- `paged_decode_attention_v2`: pages are staged in groups of
  ``pages_per_group`` into shared memory with cp.async, double-buffered,
  so a group lands while the previous one is computed.

Both launch the hand-written CUDA kernels of ``csrc/paged_attention.cu``
on CUDA tensors (or raise) and run the plain version
`paged_decode_reference` on CPU tensors, counting ``.launches`` and
``.plain_calls``. Accumulation is f32; the output takes q's dtype
(float32 or bfloat16). A length past the table's capacity reads only the
table's pages, table entries are clamped to the pool, and a length-0 row
is zero, as the JAX kernels give (the JAX reference gives the mean of V
there; for every length >= 1 the plain version equals it).

The gates are Hopper's, derived from what the kernels take, not from the
TPU's tiling or its 32 MB VMEM rule: `paged_kernel_eligible` (16-byte
pieces of a row over a power-of-two lane group, at most 8 query heads a
KV head in registers, a page of at most 32 KB, whose double buffer fits
a block) and `default_pages_per_group`. How many pages of a group fit
the 227 KB of shared memory a block may use is the kernel source's own
reckoning, asked through `max_pages_per_group` on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["paged_decode_attention", "paged_decode_attention_v2",
           "paged_decode_reference", "paged_decode_v2_reference",
           "paged_kernel_eligible", "default_pages_per_group",
           "max_pages_per_group"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: head dims the kernels are built for: a row is 2-32 16-byte pieces
#: spread over a power-of-two group of lanes
HEAD_DIMS = (32, 64, 128, 256)
#: query heads a block holds per KV head (its registers)
MAX_REP = 8
#: the largest page of K (or V) in bytes: double-buffered beside its V,
#: the scores and the partial sums, one page fits a block's shared memory
#: at every head dim and rep (csrc: kMaxPageBytes)
MAX_PAGE_BYTES = 32 * 1024
#: bytes of K + V one page group aims to stage: as much in flight per
#: block as fits twice (4 slots x 8 KV heads = 32 of 132 SMs at 8B, and
#: one block streams ~18 GB/s); 12 bf16 pages of 16 x 128 measured
#: fastest of 2 / 4 / 8 / 12 on an H100 80GB HBM3 at 700 W (PERF.md)
_GROUP_TARGET_BYTES = 96 * 1024


@functools.lru_cache(maxsize=None)
def max_pages_per_group(page_size: int, head_dim: int, rep: int,
                        dtype: torch.dtype) -> int:
    """The largest group of pages whose double buffer fits a block's
    shared memory, as the kernel source reckons it (ptt_paged_max_group;
    builds the library, so the card's machine only)."""
    out = ctypes.c_int(0)
    fn = _build.kernel("ptt_paged_max_group", [_I] * 4 + [_P])
    _build.check("ptt_paged_max_group",
                 fn(page_size, head_dim, rep, _build.dtype_code(dtype),
                    ctypes.byref(out)))
    return out.value


def default_pages_per_group(nj: int, page_size: int, head_dim: int = 128,
                            itemsize: int = 2) -> int:
    """Pages v2 aims to stage at once: ~96 KB of K and V a group (12 pages
    of 16 bf16 rows of 128 at Llama-3-8B's shapes), at most the table's
    nj pages. The wrapper clamps it to `max_pages_per_group`."""
    G = max(1, _GROUP_TARGET_BYTES // (2 * page_size * head_dim * itemsize))
    return max(1, min(G, nj))


def paged_kernel_eligible(H: int, KV: int, D: int, page_size: int,
                          itemsize: int = 4) -> bool:
    """Whether the kernels take the shape: whole query-head groups
    (H % KV == 0) of at most MAX_REP heads, D in HEAD_DIMS, and pages of
    1 to MAX_PAGE_BYTES bytes (`itemsize` 4, f32, is the strictest)."""
    return (KV > 0 and H % KV == 0 and H // KV <= MAX_REP
            and D in HEAD_DIMS
            and 1 <= page_size <= MAX_PAGE_BYTES // (D * itemsize))


def paged_decode_reference(q, k_pages, v_pages, lengths, page_indices,
                           scale: Optional[float] = None):
    """Plain version of both kernels: the sequence's pages gathered
    (entries clamped to the pool), f32 scores over the first
    min(lengths[b], nj * page_size) rows, a softmax that gives masked
    rows p = 0 and a length-0 row zeros."""
    B, H, D = q.shape
    KV, total, psz, _ = k_pages.shape
    rep = H // KV
    nj = page_indices.shape[1]
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    tabs = page_indices.to(dev, torch.long).clamp(0, total - 1)
    Tk = nj * psz
    ks = k_pages[:, tabs].permute(1, 0, 2, 3, 4).reshape(B, KV, Tk, D)
    vs = v_pages[:, tabs].permute(1, 0, 2, 3, 4).reshape(B, KV, Tk, D)
    qg = q.float().reshape(B, KV, rep, D)
    s = torch.einsum("bgrd,bgtd->bgrt", qg, ks.float()) * scale
    mask = (torch.arange(Tk, device=dev)[None, :]
            < lengths.to(dev, torch.long)[:, None])[:, None, None, :]
    m = torch.where(mask, s, torch.full_like(s, -float("inf"))).amax(
        -1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgrt,bgtd->bgrd", p, vs.float()) \
        / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(B, H, D).to(q.dtype)


def paged_decode_v2_reference(q, k_pages, v_pages, lengths, page_indices,
                              scale: Optional[float] = None,
                              pages_per_group: Optional[int] = None):
    """Plain version of v2: the grouping changes where pages are staged,
    not the function."""
    return paged_decode_reference(q, k_pages, v_pages, lengths,
                                  page_indices, scale)


def _check(name: str, q, k_pages, v_pages, lengths, page_indices):
    """Shape, dtype and device checks of both kernels (the shape first:
    an ineligible shape raises on any device); returns (device, int32
    lengths, int32 table)."""
    if q.dim() != 3 or k_pages.dim() != 4 \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    B, H, D = q.shape
    KV, _, psz, Dk = k_pages.shape
    if len({q.dtype, k_pages.dtype, v_pages.dtype}) != 1:
        raise TypeError(f"{name}: q and the pools share one dtype")
    _build.dtype_code(q)
    if Dk != D or not paged_kernel_eligible(H, KV, D, psz,
                                            q.element_size()):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pages {tuple(k_pages.shape)}: "
            f"needs H % KV == 0, H // KV <= {MAX_REP}, D in {HEAD_DIMS} "
            f"and pages of at most {MAX_PAGE_BYTES} bytes "
            f"(paged_kernel_eligible)")
    dev = _build.require_cuda(name, q, k_pages, v_pages)
    _build.require_aligned(name, q, k_pages, v_pages)
    lens = _build.index32(name, lengths, dev)
    tab = _build.index32(name, page_indices, dev)
    if lens.shape != (B,) or tab.dim() != 2 or tab.shape[0] != B \
            or tab.shape[1] < 1:
        raise ValueError(f"{name}: lengths {tuple(lens.shape)} and table "
                         f"{tuple(tab.shape)} for B={B}")
    return dev, lens, tab


def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                           scale: Optional[float] = None):
    """q [B, H, D]; k/v_pages [KV, total_pages, page_size, D]; lengths
    [B] int32; page_indices [B, pages_per_seq] int32. Returns [B, H, D]
    in q's dtype. v1: one page at a time."""
    if q.device.type == "cpu":
        paged_decode_attention.plain_calls += 1
        return paged_decode_reference(q, k_pages, v_pages, lengths,
                                      page_indices, scale)
    name = "paged_decode_attention"
    dev, lens, tab = _check(name, q, k_pages, v_pages, lengths,
                            page_indices)
    B, H, D = q.shape
    KV, P, psz, _ = k_pages.shape
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    fn = _build.kernel("ptt_paged_decode_v1",
                       [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             lens.data_ptr(), tab.data_ptr(), out.data_ptr(), B, H, KV, D,
             P, psz, tab.shape[1], float(scale), _build.dtype_code(q),
             dev.index or 0, _build.stream(q))
    _build.check(name, err)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_v2(q, k_pages, v_pages, lengths, page_indices,
                              scale: Optional[float] = None,
                              pages_per_group: Optional[int] = None):
    """The same function with pages staged in groups of
    ``pages_per_group`` (default `default_pages_per_group`; clamped to
    the table and to `max_pages_per_group`) by cp.async, double-buffered;
    only rows below lengths[b] are fetched."""
    if q.device.type == "cpu":
        paged_decode_attention_v2.plain_calls += 1
        return paged_decode_v2_reference(q, k_pages, v_pages, lengths,
                                         page_indices, scale,
                                         pages_per_group)
    name = "paged_decode_attention_v2"
    dev, lens, tab = _check(name, q, k_pages, v_pages, lengths,
                            page_indices)
    B, H, D = q.shape
    KV, P, psz, _ = k_pages.shape
    nj = tab.shape[1]
    if scale is None:
        scale = D ** -0.5
    if pages_per_group is None:
        pages_per_group = default_pages_per_group(nj, psz, D,
                                                  q.element_size())
    G = max(1, min(int(pages_per_group), nj,
                   max_pages_per_group(psz, D, H // KV, q.dtype)))
    out = torch.empty_like(q)
    fn = _build.kernel("ptt_paged_decode_v2",
                       [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             lens.data_ptr(), tab.data_ptr(), out.data_ptr(), B, H, KV, D,
             P, psz, nj, G, float(scale), _build.dtype_code(q),
             dev.index or 0, _build.stream(q))
    _build.check(name, err)
    paged_decode_attention_v2.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.plain_calls = 0
paged_decode_attention_v2.launches = 0
paged_decode_attention_v2.plain_calls = 0

register_oracle(
    "paged_decode_attention", kernel=paged_decode_attention,
    reference=paged_decode_reference,
    parity_test="tests/test_torch_paged.py::TestPagedV1Parity")
register_oracle(
    "paged_decode_attention_v2", kernel=paged_decode_attention_v2,
    reference=paged_decode_v2_reference,
    parity_test="tests/test_torch_paged.py::TestPagedV2Parity")
