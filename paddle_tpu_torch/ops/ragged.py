"""Ragged mixed prefill+decode paged attention (counterpart of
paddle_tpu/ops/pallas_ragged.py).

ONE launch serves a mixed batch of prefill chunks and decode tokens over
the paged KV cache. The step's new tokens ride in a FLAT buffer
q [T, H, D] with per-sequence row tables:

  - seq_start [S]:  first flat row of sequence i's new tokens;
  - num_tokens [S]: how many new tokens sequence i contributes this step
    (1 for a decode slot, the chunk length for a prefill row, 0 for an
    inactive slot — its rows come back as zeros);
  - kv_lengths [S]: sequence i's KV length INCLUDING its new tokens
    (append-then-attend: the new K/V rows are already in the pages);
  - page_tables [S, pages_per_seq]: physical pages, entries clamped to
    the pool (a -1 sentinel reads page 0, and only beyond kv_lengths).

Local token t of sequence i attends KV positions
0 .. kv_lengths[i] - num_tokens[i] + t. Query head h reads KV head
h // (H // KV) (GQA). The MLA engine passes its one latent pool as both
k_pages and v_pages (KV 1, D = r + dr = 576, H = rep = 16 at DeepSeek-V2)
and reads the output's first r dims. `ragged_paged_attention` launches the hand-written
CUDA kernel of ``csrc/ragged_attention.cu`` on CUDA tensors and runs the
plain version `ragged_attention_reference` on CPU tensors; it counts
``.launches`` and ``.plain_calls``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["ragged_paged_attention", "ragged_attention_reference"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NEG = -1e30
#: head dims the kernel is built for (576: the MLA latent row, r + dr =
#: 512 + 64 of DeepSeek-V2, over one KV head)
HEAD_DIMS = (32, 64, 128, 256, 576)
#: shared memory a block may use (the H100's 227 KB, past the 48 KB
#: default through the dynamic opt-in the kernel takes)
_SMEM_LIMIT = 232448


def staging_bytes(page_size: int, head_dim: int, same_pool: bool) -> int:
    """Shared memory a block of the kernel stages a page in: one f32 K and
    one f32 V page, or one page read as both when the K and V pools are the
    same tensor (the MLA engine's one latent pool)."""
    return (1 if same_pool else 2) * page_size * head_dim * 4


def ragged_attention_reference(q, k_pages, v_pages, seq_start, num_tokens,
                               kv_lengths, page_tables,
                               scale: Optional[float] = None):
    """Plain version with the same ragged semantics: gathered pages, a
    repeat for GQA, a full f32 softmax."""
    T, H, D = q.shape
    KV, total, psz, _ = k_pages.shape
    rep = H // KV
    S, nj = page_tables.shape
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    ss = seq_start.to(dev, torch.long)
    nt = num_tokens.to(dev, torch.long)
    kvl = kv_lengths.to(dev, torch.long)
    tabs = page_tables.to(dev, torch.long).clamp(0, total - 1)
    Tk = nj * psz
    ks = k_pages[:, tabs].permute(1, 0, 2, 3, 4).reshape(S, KV, Tk, D)
    vs = v_pages[:, tabs].permute(1, 0, 2, 3, 4).reshape(S, KV, Tk, D)
    kr = ks.repeat_interleave(rep, dim=1).float()         # [S, H, Tk, D]
    vr = vs.repeat_interleave(rep, dim=1).float()
    logits = torch.einsum("thd,shld->shtl", q.float(), kr) * scale
    t_idx = torch.arange(T, device=dev)
    rv = (t_idx[None, :] >= ss[:, None]) & \
        (t_idx[None, :] < (ss + nt)[:, None])             # [S, T]
    limit = (kvl - nt)[:, None] + (t_idx[None, :] - ss[:, None])
    pos = torch.arange(Tk, device=dev)
    mask = rv[:, None, :, None] & \
        (pos[None, None, None, :] <= limit[:, None, :, None])
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    m = logits.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("shtl,shld->shtd",
                     p / torch.where(l == 0.0, torch.ones_like(l), l), vr)
    out = torch.where(rv[:, None, :, None], o, torch.zeros_like(o)).sum(0)
    return out.permute(1, 0, 2).to(q.dtype)


def ragged_paged_attention(q, k_pages, v_pages, seq_start, num_tokens,
                           kv_lengths, page_tables,
                           scale: Optional[float] = None):
    """q [T, H, D] flat new-token buffer; k/v_pages [KV, total_pages,
    page_size, D]; seq_start/num_tokens/kv_lengths [S]; page_tables
    [S, pages_per_seq]. Sequences own DISJOINT row ranges; rows covered by
    no sequence return zeros. Returns [T, H, D] in q's dtype."""
    if q.device.type == "cpu":
        ragged_paged_attention.plain_calls += 1
        return ragged_attention_reference(q, k_pages, v_pages, seq_start,
                                          num_tokens, kv_lengths,
                                          page_tables, scale)
    name = "ragged_paged_attention"
    dev = _build.require_cuda(name, q, k_pages, v_pages)
    T, H, D = q.shape
    KV, P, psz, Dk = k_pages.shape
    if (Dk != D or v_pages.shape != k_pages.shape or H % KV
            or D not in HEAD_DIMS):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pages {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)}; needs H % KV == 0 and D in "
            f"{HEAD_DIMS}")
    same = k_pages.data_ptr() == v_pages.data_ptr()
    if staging_bytes(psz, D, same) > _SMEM_LIMIT:
        raise ValueError(f"{name}: page_size {psz} x head_dim {D} stages "
                         f"{staging_bytes(psz, D, same)} bytes, over the "
                         f"{_SMEM_LIMIT} a block may use")
    if len({q.dtype, k_pages.dtype, v_pages.dtype}) != 1:
        raise TypeError(f"{name}: q and the pools share one dtype")
    ss = _build.index32(name, seq_start, dev)
    nt = _build.index32(name, num_tokens, dev)
    kvl = _build.index32(name, kv_lengths, dev)
    tab = _build.index32(name, page_tables, dev)
    S = ss.shape[0]
    if nt.shape != (S,) or kvl.shape != (S,) or tab.dim() != 2 \
            or tab.shape[0] != S:
        raise ValueError(f"{name}: row tables disagree on S={S}")
    nj = tab.shape[1]
    if scale is None:
        scale = D ** -0.5
    out = torch.zeros_like(q)       # rows no sequence owns stay zero
    fn = _build.kernel("ptt_ragged_attention",
                       [_P] * 8 + [_I] * 8 + [_F, _I, _I, _P])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             ss.data_ptr(), nt.data_ptr(), kvl.data_ptr(), tab.data_ptr(),
             out.data_ptr(), T, H, KV, D, P, psz, S, nj, float(scale),
             _build.dtype_code(q), dev.index or 0, _build.stream(q))
    _build.check(name, err)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.plain_calls = 0


register_oracle(
    "ragged_paged_attention", kernel=ragged_paged_attention,
    reference=ragged_attention_reference,
    parity_test="tests/test_torch_ops.py::TestRaggedParity")
