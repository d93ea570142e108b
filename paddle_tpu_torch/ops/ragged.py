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
CUDA kernels of ``csrc/ragged_attention.cu`` on CUDA tensors (bf16: split-KV
work items on the tensor cores, the splits from `ragged_split_plan` and
merged in the same launch; f32: a block per (16-row tile, KV head,
sequence) on the CUDA cores) and runs the plain version
`ragged_attention_reference` on CPU tensors; a CUDA tensor launches a
kernel or raises. It counts ``.launches`` and ``.plain_calls``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["ragged_paged_attention", "ragged_attention_reference",
           "ragged_split_plan"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NEG = -1e30
#: head dims the kernel is built for (576: the MLA latent row, r + dr =
#: 512 + 64 of DeepSeek-V2, over one KV head)
HEAD_DIMS = (32, 64, 128, 256, 576)
#: shared memory a block may use (the H100's 227 KB, past the 48 KB
#: default through the dynamic opt-in the kernels take)
_SMEM_LIMIT = 232448
#: the bf16 kernel's keys a split are a multiple of this (its largest
#: stage, 64 keys)
SPLIT_QUANTUM = 64
#: K and V bytes a split moves at least (a 16-row tile at head dim D reads
#: 4 D bytes a key), so that a block's ring fills a few times over
SPLIT_MIN_BYTES = 64 * 1024
#: items an SM that a decode step's splits aim at (at full length; the
#: D 128 kernel holds two blocks an SM, and a third item an SM read best
#: at GPT-3 6.7B's step and the long one, `ragged_limits.py --splits`)
SPLIT_BLOCKS_PER_SM = 3
#: the f32 split partials a launch may need at most
SPLIT_WORKSPACE_BYTES = 64 << 20
#: table entries a split may span (csrc/ragged_attention.cu `rag::SPG`,
#: staged in shared memory a split; the kernel refuses a longer split)
SPLIT_PAGES = 512


def staging_bytes(page_size: int, head_dim: int, same_pool: bool) -> int:
    """Shared memory a block of the f32 kernel stages a page in: one f32 K
    and one f32 V page, or one page read as both when the K and V pools are
    the same tensor (the MLA engine's one latent pool). (The bf16 kernel
    stages rows of any page size; its launch refuses what the card cannot
    hold.)"""
    return (1 if same_pool else 2) * page_size * head_dim * 4


def ragged_split_plan(S: int, KV: int, rep: int, T: int, capacity: int,
                      sms: int, head_dim: int = 128, page_size: int = 16):
    """(keys a split, splits of the capacity, work items at most) of the
    bf16 kernel, from the shapes only (the host never reads the lengths
    or the tables): S sequences over KV heads of rep query heads, a T-row
    buffer, page tables of `capacity` = pages_per_seq x page_size keys, a
    card of `sms` SMs. A decode step's items are S x KV x splits (one
    16-row tile a sequence and head at rep <= 16); the split is capacity
    over the splits that make them SPLIT_BLOCKS_PER_SM items an SM at full
    length, rounded up to a multiple of SPLIT_QUANTUM, but moves at least
    SPLIT_MIN_BYTES, and the items' f32 partials (16 x head_dim sums and
    16 (m, l) pairs an item, at most KV x (ceil(T rep / 16) + S) tiles x
    splits items) stay within SPLIT_WORKSPACE_BYTES; a split spans at most
    SPLIT_PAGES table entries of `page_size` keys. Split s covers keys [s k, (s + 1) k):
    every visible (row, key) pair falls in exactly one split. (The kernel
    leaves a sequence unsplit when its KV x 16-row tiles alone are at
    least half of `sms` items and its keys span fewer than SPLIT_PAGES
    pages: a prefill chunk's tiles fill the card without splits.)"""
    if S <= 0 or KV <= 0 or capacity <= 0:
        return SPLIT_QUANTUM, 0, 0
    q = SPLIT_QUANTUM

    def up(n):
        return -(-n // q) * q

    streams = S * KV * -(-rep // 16)
    want = -(-SPLIT_BLOCKS_PER_SM * sms // streams)
    keys = max(up(-(-SPLIT_MIN_BYTES // (4 * head_dim))),
               up(-(-capacity // want)))
    tiles = -(-T * rep // 16) + S
    most = max(1, SPLIT_WORKSPACE_BYTES
               // (KV * tiles * (16 * head_dim + 32) * 4))
    if -(-capacity // keys) > most:
        keys = up(-(-capacity // most))
    keys = min(keys, (SPLIT_PAGES - 1) * page_size // q * q)
    nsplit = -(-capacity // keys)
    return keys, nsplit, KV * tiles * nsplit


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
    out = _launch(q, k_pages, v_pages, seq_start, num_tokens, kv_lengths,
                  page_tables, scale)
    ragged_paged_attention.launches += 1
    return out


#: (device index, stream handle) -> the bf16 kernel's split workspace:
#: int32 counters and f32 partials ((m, l) pairs first). The launches of
#: one stream run in order, each leaves the counters zero (the last split
#: of a tile resets its counter) and reads back only the partials it
#: wrote, so the next launch on that stream reuses both; another stream
#: has its own.
_workspaces: dict = {}


def _split_workspace(items: int, D: int, t: torch.Tensor, st: int):
    """(partials [items, 16 D], (m, l) [items, 32], counters [items]) for
    a launch on t's device and stream `st`; the counters zero."""
    key = (t.device.index or 0, st)
    cnt, f32 = _workspaces.get(key, (None, None))
    if cnt is None or cnt.numel() < items:
        cnt = torch.zeros(max(items, 4096), dtype=torch.int32,
                          device=t.device)
    if f32 is None or f32.numel() < items * (16 * D + 32):
        f32 = torch.empty(items * (16 * D + 32), dtype=torch.float32,
                          device=t.device)
    _workspaces[key] = cnt, f32
    return f32[items * 32:], f32[:items * 32], cnt


def _launch(q, k_pages, v_pages, seq_start, num_tokens, kv_lengths,
            page_tables, scale: Optional[float] = None,
            split: Optional[int] = None):
    """The CUDA kernel of q's dtype; `split` (keys a split, bf16) replaces
    `ragged_split_plan`'s (the card tests put split boundaries inside
    pages with it; `ragged_limits.py --splits` times other splits)."""
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
    if len({q.dtype, k_pages.dtype, v_pages.dtype}) != 1:
        raise TypeError(f"{name}: q and the pools share one dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    same = k_pages.data_ptr() == v_pages.data_ptr()
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
    if q.dtype == torch.float32:
        smem = staging_bytes(psz, D, same)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"{name}: page_size {psz} x head_dim {D} "
                             f"stages {smem} bytes, over the {_SMEM_LIMIT} "
                             f"a block may use (ROADMAP.md R1)")
        out = torch.zeros_like(q)       # rows no sequence owns stay zero
        fn = _build.kernel("ptt_ragged_attention",
                           [_P] * 8 + [_I] * 8 + [_F, _I, _I, _P])
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 ss.data_ptr(), nt.data_ptr(), kvl.data_ptr(),
                 tab.data_ptr(), out.data_ptr(), T, H, KV, D, P, psz, S, nj,
                 float(scale), _build.dtype_code(q), dev.index or 0,
                 _build.stream(q))
        _build.check(name, err)
        return out
    _build.require_aligned(name, q, k_pages, v_pages)
    cap = nj * psz
    if T == 0 or S == 0 or cap == 0:
        return torch.zeros_like(q)
    keys, nsplit, items = ragged_split_plan(
        S, KV, H // KV, T, cap, _build.sm_count(dev), D, psz)
    if split is not None:
        keys = split
        nsplit = -(-cap // keys)
        items = KV * (-(-T * (H // KV) // 16) + S) * nsplit
    out = torch.empty_like(q)       # the kernel writes every row
    st = _build.stream(q)
    part = pml = cnt = None
    if nsplit > 1:
        part, pml, cnt = _split_workspace(items, D, q, st)
    fn = _build.kernel("ptt_ragged_bf16", [_P] * 11 + [_I] * 10
                       + [_F, _I, _P])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             ss.data_ptr(), nt.data_ptr(), kvl.data_ptr(), tab.data_ptr(),
             out.data_ptr(), _build.ptr(part), _build.ptr(pml),
             _build.ptr(cnt), T, H, KV, D, P, psz, S, nj, keys, items,
             float(scale), dev.index or 0, st)
    if err:
        # a refused launch may leave counts behind: the next launch on this
        # stream takes fresh zeros
        _workspaces.pop((dev.index or 0, st), None)
        # e.g. more shared memory than a block may take: the kernel stages
        # the sequences' rows beside its ring (S past several thousand)
        _build.check(f"{name} (bf16 at S {S}; ROADMAP.md R1)", err)
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.plain_calls = 0


register_oracle(
    "ragged_paged_attention", kernel=ragged_paged_attention,
    reference=ragged_attention_reference,
    parity_test="tests/test_torch_ops.py::TestRaggedParity")
