"""Attention routing (counterpart of paddle_tpu/ops/flash_attention.py).

`sdpa` routes ``[B, S, H, D]`` scaled-dot-product attention to the flash
kernel (`flash.flash_sdpa`) where its gate holds, a boolean key-padding
mask through the same kernel's segment ids, and everything else to the
dense composite `sdpa_reference`, as the JAX package routes. The gate is
Hopper's (`flash.flash_kernel_eligible`: head_dim 64, 128 or 192, any
length)
in place of the TPU's (a TPU backend and 128-divisible lengths), and it
holds on the CPU too: there the flash wrapper runs its plain version.
Where some key is visible to a row the routes agree; a row that sees no
key is zero on the flash routes and the mean of v on the composite.

`flash_attn_unpadded` turns cu_seqlens into segment ids on the device and
runs `sdpa_segmented`; `flashmask_attention` routes Paddle's FlashMask
encodings to the FlashMask kernel (`flashmask.flashmask_sdpa`) or, with
dropout or a head dim the JAX package's gate refuses, to the dense
composite. Both FlashMask routes mask causally TOP-LEFT (key j hidden
from row i when j > i), as the reference kernel does; the reference's
composite is bottom-right aligned there, which differs when Sq != Sk
(ROADMAP.md queue C, C3).

``route_counts`` counts the routes eager calls take, so a run can show
which one its attention went through. A program captured by ``jit``
(``to_static`` / ``fuse``) is not counted, whatever its routes: read the
kernels' launch counts (``ops.launch_counts``) around such a program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .flash import HEAD_DIMS, flash_kernel_eligible, flash_sdpa
from .flashmask import (band_hidden, bands_from_startend, check_shapes,
                        flashmask_sdpa)

__all__ = ["sdpa_reference", "sdpa", "sdpa_path", "sdpa_segmented",
           "sdpa_prefill", "sdpa_padded_heads", "flash_attention",
           "flash_attn_unpadded", "flashmask_attention", "route_counts",
           "reset_route_counts"]

_NEG = -1e30

#: eager calls of `sdpa` / `sdpa_segmented` / `flashmask_attention` by
#: route; calls inside a captured program are not counted (`_count`)
route_counts: Dict[str, int] = {"flash": 0, "flash_segmented": 0,
                                "composite": 0, "flashmask": 0,
                                "flashmask_composite": 0}


def reset_route_counts() -> None:
    for k in route_counts:
        route_counts[k] = 0


def _count(route: str) -> None:
    """Count an eager call's route. A program under graph capture
    (``jit.fusion``) fixes its routes when it is captured and is never
    counted, neither then nor when its graphs run: a counter read during
    capture would be guarded on, and every call would capture the
    program again. Its kernels' launch counts show what it ran."""
    if not torch.compiler.is_compiling():
        route_counts[route] += 1


def sdpa_reference(q, k, v, mask=None, causal: bool = False,
                   dropout_p: float = 0.0, scale: Optional[float] = None):
    """[B, S, H, D] attention in the JAX composite's op order: logits in
    the input dtype, then an f32 softmax, probabilities cast back to the
    input dtype before the product with v. A bool mask keeps the entries
    where it is True ([B, Sk] bool is key padding); a float mask adds."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = logits.float()
    if causal:
        cm = torch.ones(Sq, Sk, dtype=torch.bool,
                        device=q.device).tril(Sk - Sq)
        logits = torch.where(cm, logits, torch.full_like(logits, _NEG))
    if mask is not None:
        m = torch.as_tensor(mask, device=q.device)
        # only a BOOL [B, Sk] mask is key padding; a float [Sq, Sk]
        # additive mask with B == Sq keeps its broadcast meaning
        if m.dim() == 2 and tuple(m.shape) == (B, Sk) and \
                m.dtype == torch.bool:
            m = m[:, None, None, :]
        if m.dtype == torch.bool:
            logits = torch.where(m, logits, torch.full_like(logits, _NEG))
        else:
            logits = logits + m.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand_like(probs, dtype=torch.float32) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _flash_eligible(q, k, causal: bool = False) -> bool:
    """Hopper's gate: a dtype the kernels take and a shape
    `flash_kernel_eligible` accepts."""
    return (q.dtype in (torch.float32, torch.bfloat16)
            and flash_kernel_eligible(q.shape[1], k.shape[1], q.shape[-1]))


def _as_key_padding(mask, B, Sq, Sk):
    """A boolean KEY mask ([B, Sk], [B, 1, Sk] or [B, 1, 1, Sk]) as
    [B, Sk] bool; anything else None."""
    m = torch.as_tensor(mask)
    if m.dtype != torch.bool:
        return None
    if tuple(m.shape) == (B, Sk):
        return m
    if tuple(m.shape) in ((B, 1, Sk), (B, 1, 1, Sk)):
        return m.reshape(B, Sk)
    return None


def sdpa_path(q, k, mask=None, causal: bool = False,
              dropout_p: float = 0.0) -> str:
    """The route `sdpa` takes for this call: "flash",
    "flash_segmented" or "composite"."""
    B, Sq = q.shape[0], q.shape[1]
    Sk = k.shape[1]
    if dropout_p != 0.0 or not _flash_eligible(q, k, causal):
        return "composite"
    if mask is None:
        return "flash"
    if _as_key_padding(mask, B, Sq, Sk) is not None:
        return "flash_segmented"
    return "composite"


def sdpa(q, k, v, mask=None, causal: bool = False, dropout_p: float = 0.0,
         scale: Optional[float] = None):
    """Routing SDPA on [B, S, H, D] tensors. A boolean key-padding mask
    goes through the flash kernel's segment ids: masked keys get segment
    0, every query row segment 1, so masked keys are excluded for every
    row, as in the composite."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    path = sdpa_path(q, k, mask=mask, causal=causal, dropout_p=dropout_p)
    if path == "flash":
        _count("flash")
        return flash_sdpa(q, k, v, causal=causal, scale=scale)
    if path == "flash_segmented":
        pad = _as_key_padding(mask, B, Sq, Sk).to(q.device)
        seg_q = torch.ones(B, Sq, dtype=torch.int32, device=q.device)
        return sdpa_segmented(q, k, v, seg_q, kv_segment_ids=pad.int(),
                              causal=causal, scale=scale)
    _count("composite")
    if mask is not None:
        pad = _as_key_padding(mask, B, Sq, Sk)
        if pad is not None:
            mask = pad[:, None, None, :]
    return sdpa_reference(q, k, v, mask=mask, causal=causal,
                          dropout_p=dropout_p, scale=scale)


def sdpa_segmented(q, k, v, segment_ids, kv_segment_ids=None, causal=True,
                   scale=None, dropout_p: float = 0.0):
    """[B, S, H, D] with [B, S] int segment ids: rows attend only within
    their segment (kv_segment_ids defaults to segment_ids). The flash
    kernel where its gate holds, else the masked composite."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    seg_q = segment_ids.to(torch.int32)
    seg_kv = seg_q if kv_segment_ids is None \
        else kv_segment_ids.to(torch.int32)
    if dropout_p == 0.0 and _flash_eligible(q, k, causal):
        _count("flash_segmented")
        return flash_sdpa(q, k, v, causal=causal, scale=scale,
                          segment_ids_q=seg_q, segment_ids_kv=seg_kv)
    _count("composite")
    same = seg_q[:, :, None] == seg_kv[:, None, :]
    return sdpa_reference(q, k, v, mask=same[:, None], causal=causal,
                          scale=scale, dropout_p=dropout_p)


def sdpa_prefill(q, k, v, *, causal: bool = True,
                 scale: Optional[float] = None,
                 pad_to_flash_min: int = 1024):
    """Prefill-shaped SDPA ([B, S, H, D], self-attention, no mask), the
    JAX package's signature. On the TPU it zero-pads a prompt of at least
    ``pad_to_flash_min`` tokens to the next multiple of 128 and runs the
    segment-id flash kernel, only to meet the TPU flash gate; that padding
    is exact (no real row attends a padded key, padded rows are sliced
    off), so it changes nothing but the route. The Hopper flash kernel
    masks ragged tiles itself (any length), so here every prompt goes
    straight to `sdpa` and ``pad_to_flash_min`` has no counterpart."""
    return sdpa(q, k, v, causal=causal, scale=scale)


def sdpa_padded_heads(q, k, v, *, causal: bool = True,
                      scale: Optional[float] = None):
    """SDPA for MLA heads whose q / k head dim differs from the v head dim
    (DeepSeek-V2: dn + dr = 192 against dv = 128). q / k and v are
    zero-padded to the smallest head dim of `flash.HEAD_DIMS` that holds
    both (192 for DeepSeek-V2, 64 for the tiny configs), which preserves
    every score (a padded dim adds 0 to each logit) and every output (a
    padded v dim yields zeros, sliced off), so the prefill takes the flash
    route. The JAX package pads to the next multiple of 128 for the TPU's
    lanes; the Hopper kernel takes 192 as it is. ``scale`` must be the
    caller's true 1 / sqrt(d_qk); the default is q's unpadded dim's."""
    D, Dv = q.shape[-1], v.shape[-1]
    if scale is None:
        scale = D ** -0.5
    Dp = next((d for d in HEAD_DIMS if d >= max(D, Dv)), max(D, Dv))
    if D != Dp:
        q = torch.nn.functional.pad(q, (0, Dp - D))
        k = torch.nn.functional.pad(k, (0, Dp - D))
    if Dv != Dp:
        v = torch.nn.functional.pad(v, (0, Dp - Dv))
    return sdpa_prefill(q, k, v, causal=causal, scale=scale)[..., :Dv]


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, name=None):
    """paddle.nn.functional.flash_attention.flash_attention: returns
    (out, None); the softmax is never materialized."""
    return sdpa(query, key, value, causal=causal, dropout_p=dropout), None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        name=None):
    """paddle.nn.functional.flash_attention.flash_attn_unpadded: packed
    [total, H, D] q / k / v and cu_seqlens -> per-sequence attention,
    returned as (out [total_q, H, D], None). The segment id of token t is
    the number of sequence starts <= t, found on the device by
    ``searchsorted`` (no host read); the packed batch then runs as one
    [1, total] row through `sdpa_segmented`. As in the JAX package, causal
    masking aligns the packed totals (bottom-right when total_q !=
    total_k), not each sequence."""
    def segments(cu, n):
        cu = cu.to(query.device).contiguous()
        pos = torch.arange(n, dtype=cu.dtype, device=cu.device)
        return torch.searchsorted(cu, pos, right=True).to(torch.int32)

    out = sdpa_segmented(query[None], key[None], value[None],
                         segments(cu_seqlens_q, query.shape[0])[None],
                         kv_segment_ids=segments(cu_seqlens_k,
                                                 key.shape[0])[None],
                         causal=causal, scale=scale, dropout_p=dropout)
    return out[0], None


def _flashmask_head_dim(D: int) -> bool:
    """The head dims the JAX package sends to its FlashMask kernel."""
    return D % 128 == 0 or (D <= 128 and D % 64 == 0)


def flashmask_attention(query, key, value, startend_row_indices,
                        dropout=0.0, causal=False, name=None):
    """paddle.nn.functional.flashmask_attention: [B, S, H, D] attention
    under the FlashMask column encoding ``startend_row_indices`` [B, Hm,
    Sk, C] (Hm 1 or H; `flashmask.bands_from_startend` says what each C
    masks), returned as (out, None).

    Dropout > 0, or a head dim the JAX package's kernel gate refuses,
    takes the dense composite (`sdpa_reference` over the band mask);
    everything else the FlashMask kernel, whatever the lengths (the
    Hopper tiles mask their edges). A head dim the TPU kernel takes and
    the Hopper one does not (above 128) raises there on CUDA tensors; on
    CPU tensors the kernel route runs its plain version.

    Where a row sees some key both routes agree. A row that sees no key
    is zero on the kernel route, which the reference kernel documents for
    such rows (paddle_tpu/ops/pallas_flashmask.py:24-26). The JAX entry
    point also gates its kernel on the lengths (multiples of 128) and
    sends other lengths to its composite, where such a row is the mean of
    v; the port keeps the kernel's zero at every length (ROADMAP.md queue
    C, C4), so at those lengths its empty rows differ from the JAX
    entry's."""
    check_shapes(query, key, value, startend_row_indices)
    if dropout == 0.0 and _flashmask_head_dim(query.shape[-1]):
        _count("flashmask")
        return flashmask_sdpa(query, key, value, startend_row_indices,
                              causal=causal), None
    _count("flashmask_composite")
    return _flashmask_composite(query, key, value, startend_row_indices,
                                causal, dropout), None


def _flashmask_composite(q, k, v, startend_row_indices, causal, dropout=0.0):
    """`flashmask_attention`'s composite route: `sdpa_reference` over the
    dense band mask, the causal diagonal folded in top-left."""
    Sq, Sk = q.shape[1], k.shape[1]
    bands = bands_from_startend(startend_row_indices.to(q.device), Sq, Sk,
                                causal)
    return sdpa_reference(q, k, v, mask=~band_hidden(bands, Sq, Sk, causal),
                          dropout_p=dropout)
