"""Absorbed-MLA decode attention (counterpart of
paddle_tpu/ops/pallas_mla.py).

Absorbed MLA decode is multi-query attention over one latent stream:
every query head of a sequence attends K[t] = [c_lat[t] | c_pe[t]] and
V[t] = c_lat[t]. ``mla_decode_attention`` launches the hand-written CUDA
kernels of ``csrc/mla.cu`` on CUDA tensors (two CUDA kernels a call,
counted as one launch: a block per (sequence, split of the cache) that
reads each cache tile once for the scores and the weighted sum, then a
merge of the splits; bf16 on the tensor cores with its splits from
`mla_split_plan`, f32 on the CUDA cores in SPLIT_ROWS-row splits) and
runs its plain PyTorch version ``mla_decode_reference`` on CPU tensors. A
CUDA tensor launches the kernel or raises; nothing falls back. The
wrapper counts ``.launches`` and ``.plain_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["mla_decode_attention", "mla_decode_reference",
           "mla_kernel_eligible", "mla_split_plan"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NEG = -1e30
#: cache rows a block of the f32 kernel walks (its split); a multiple of
#: its 32-row tile
SPLIT_ROWS = 256
#: the bf16 kernel's tile of cache rows; its splits are multiples of it
TILE_ROWS = 16


def mla_split_plan(B: int, Tc: int, sms: int):
    """(rows a split, splits a sequence) of the bf16 kernel: the largest
    multiple of TILE_ROWS (at least one tile) such that B x splits reaches
    `sms` blocks, so that a decode step of few sequences still fills the
    card (4 x 544 on 132 SMs: 16 rows, 136 blocks; 8 x 8192: 480 rows, 144
    blocks). A function of the shapes only: the host never reads the
    lengths."""
    want = -(-sms // max(B, 1))
    rows = max(TILE_ROWS, Tc // want // TILE_ROWS * TILE_ROWS)
    return rows, -(-Tc // rows)


def mla_kernel_eligible(nh: int, r: int, dr: int) -> bool:
    """Shapes the Hopper kernels take, from what they hold: r a power of
    two from 32 to 512 (f32: r / 32 dims a lane in registers; bf16: r / 4
    output columns a warp, one of the five builds 32 .. 512), dr 32 or 64
    (16-byte row copies; f32: two dims a lane at most) and an even nh up to
    32 (f32: two heads a warp; bf16: one or two m16 tiles of heads). The
    TPU's r % 128 lane rule does not transfer."""
    return (r in (32, 64, 128, 256, 512) and dr in (32, 64)
            and nh >= 2 and nh % 2 == 0 and nh <= 32)


def mla_decode_reference(q_eff, q_pe, c_lat, c_pe, lengths, *,
                         scale: float, block_t: int = 1024):
    """Plain version, the kernel's arithmetic in one block: f32 scores,
    keys t >= lengths[b] hidden, exp(s - max) in f32, the probabilities
    rounded to the cache dtype before the f32 product with c_lat (rows
    past the length zeroed, never multiplied), divided by the f32 sum.
    ``block_t`` is the TPU's tiling, accepted for the JAX signature."""
    del block_t
    Tc = c_lat.shape[1]
    s = (torch.einsum("bhr,btr->bht", q_eff.float(), c_lat.float())
         + torch.einsum("bhd,btd->bht", q_pe.float(), c_pe.float())) * scale
    dead = torch.arange(Tc, device=c_lat.device)[None, None, :] >= \
        lengths.to(c_lat.device, torch.long)[:, None, None]
    s = torch.where(dead, torch.full_like(s, _NEG), s)
    m = s.amax(-1, keepdim=True)
    p = torch.where(dead, torch.zeros_like(s), torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    live = torch.where(dead[:, 0, :, None], torch.zeros_like(c_lat),
                       c_lat)
    o = torch.einsum("bht,btr->bhr", p.to(c_lat.dtype).float(),
                     live.float())
    return (o / torch.where(l == 0.0, torch.ones_like(l), l)).to(c_lat.dtype)


def mla_decode_attention(q_eff, q_pe, c_lat, c_pe, lengths, *,
                         scale: float, block_t: int = 1024):
    """One MLA decode step over the absorbed latent cache.

    q_eff [B, nh, r] (q_nope with kv_b's key half absorbed), q_pe [B, nh,
    dr] (the roped query tail), c_lat [B, T, r] (the normalized latent
    cache, key and value), c_pe [B, T, dr] (the rope key cache, shared by
    the heads), lengths [B] int (valid tokens a sequence, on the tensors'
    device). Returns [B, nh, r] in c_lat's dtype. ``block_t`` is the
    TPU's tiling, accepted for the JAX signature only."""
    if c_lat.device.type == "cpu":
        mla_decode_attention.plain_calls += 1
        return mla_decode_reference(q_eff, q_pe, c_lat, c_pe, lengths,
                                    scale=scale)
    name = "mla_decode_attention"
    dev = _build.require_cuda(name, q_eff, q_pe, c_lat, c_pe)
    B, nh, r = q_eff.shape
    dr = q_pe.shape[-1]
    Tc = c_lat.shape[1]
    if (q_pe.shape != (B, nh, dr) or c_lat.shape != (B, Tc, r)
            or c_pe.shape != (B, Tc, dr)):
        raise ValueError(
            f"{name}: q_eff {tuple(q_eff.shape)} q_pe {tuple(q_pe.shape)} "
            f"c_lat {tuple(c_lat.shape)} c_pe {tuple(c_pe.shape)}")
    if not mla_kernel_eligible(nh, r, dr):
        raise ValueError(
            f"{name}: nh {nh}, r {r}, dr {dr}; the kernel takes r in "
            f"32..512 (a power of two), dr 32 or 64 and an even nh <= 32 "
            f"(see mla_kernel_eligible)")
    if len({q_eff.dtype, q_pe.dtype, c_lat.dtype, c_pe.dtype}) != 1:
        raise TypeError(f"{name}: q and the caches share one dtype")
    _build.require_aligned(name, c_lat, c_pe)
    lens = _build.index32(name, lengths, dev)
    if lens.shape != (B,):
        raise ValueError(f"{name}: lengths must be [B={B}]")
    out = torch.empty(B, nh, r, dtype=c_lat.dtype, device=dev)
    if B == 0:
        return out
    if c_lat.dtype == torch.bfloat16:
        rows, nsplit = mla_split_plan(B, Tc, _build.sm_count(dev))
    else:
        rows, nsplit = SPLIT_ROWS, -(-Tc // SPLIT_ROWS)
    acc = torch.empty(B, nsplit, nh, r, dtype=torch.float32, device=dev)
    ml = torch.empty(B, nsplit, nh, 2, dtype=torch.float32, device=dev)
    fn = _build.kernel("ptt_mla_decode", [_P] * 8 + [_I] * 6
                       + [_F, _I, _I, _P])
    err = fn(q_eff.data_ptr(), q_pe.data_ptr(), c_lat.data_ptr(),
             c_pe.data_ptr(), lens.data_ptr(), acc.data_ptr(), ml.data_ptr(),
             out.data_ptr(), B, nh, r, dr, Tc, rows, float(scale),
             _build.dtype_code(c_lat), dev.index or 0, _build.stream(c_lat))
    _build.check(name, err)
    mla_decode_attention.launches += 1
    return out


mla_decode_attention.launches = 0
mla_decode_attention.plain_calls = 0


register_oracle(
    "mla_decode_attention", kernel=mla_decode_attention,
    reference=mla_decode_reference,
    parity_test="tests/test_torch_deepseek.py::TestMlaDecodeParity")
