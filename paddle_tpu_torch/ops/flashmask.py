"""FlashMask attention, forward and backward (counterpart of
paddle_tpu/ops/pallas_flashmask.py).

`flashmask_sdpa` takes ``[B, S, H, D]`` q / k / v and Paddle's FlashMask
column encoding ``startend_row_indices`` ``[B, Hm, Sk, C]`` (Hm 1 or H, C
1, 2 or 4), which `bands_from_startend` reduces to two masked row bands a
key column, ``[s1, e1)`` and ``[s2, e2)``. Key j is hidden from row i when
i lies in either band of column j or, under ``causal``, when j > i: the
causal mask is TOP-LEFT aligned, as the reference kernel applies it
(``pallas_flashmask.py:141``), not bottom-right as flash's is (ROADMAP.md
queue C, C3). The dense mask never exists on the kernel route: the kernels
of ``csrc/flashmask.cu`` read the bands a column at a time and skip every
64 x 64 tile that one band or the diagonal covers whole.

On CUDA tensors it runs those kernels through `torch.autograd.Function`
(the forward writes o and an f32 logsumexp; `flashmask_sdpa_bwd` launches
the di pre-pass, dq and dkv); on CPU tensors the plain version
`flashmask_sdpa_reference`, a dense f32 softmax over the band mask that
autograd differentiates. A CUDA tensor launches the kernels or raises;
nothing falls back. A row that sees no key is zero (lse +1e30) with zero
gradients.

The kernels take head_dim 64 and 128 (`HEAD_DIMS`); the TPU kernel also
takes multiples of 128 above it, which raise here naming ROADMAP.md
queue A, A2b. k and v carry q's head count (no grouped-query attention,
as in the reference, whose composite fails on it).

Counts: ``flashmask_sdpa.launches`` counts forward calls (the tile
pre-pass and the forward kernel), ``flashmask_sdpa_bwd.launches`` backward
calls (the pre-pass, di, dq and dkv); ``.plain_calls`` the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.nn import functional as F

from . import _build
from .flash import _kernel_operand, _strides, masked_attention
from .oracles import register_oracle

__all__ = ["bands_from_startend", "band_hidden", "flashmask_block_kinds",
           "flashmask_kernel_eligible", "flashmask_sdpa",
           "flashmask_sdpa_bwd", "flashmask_sdpa_reference",
           "flashmask_sdpa_bwd_reference", "check_shapes", "HEAD_DIMS",
           "TILE"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: head dims the kernels are built for
HEAD_DIMS = (64, 128)
#: the kernels' q and k tiles (csrc/flash_tiles.cuh BQ, BKV)
TILE = 64


def bands_from_startend(se, Sq: int, Sk: int, causal: bool):
    """Paddle's startend_row_indices [B, Hm, Sk, C] -> the two masked bands
    (s1, e1, s2, e2), each int32 [B, Hm, Sk]: causal C=1 is [start, Sq),
    causal C=2 [start, end), non-causal C=2 [lt_start, Sq) and [0, ut_end),
    non-causal C=4 both bands as given."""
    C = se.shape[-1]
    se = se.to(torch.int32)
    big = torch.full(se.shape[:-1], Sq, dtype=torch.int32, device=se.device)
    zero = torch.zeros_like(big)
    if C == 1:
        if not causal:
            raise ValueError("C=1 FlashMask (LTS) requires causal=True")
        return se[..., 0], big, zero, zero
    if C == 2 and causal:
        return se[..., 0], se[..., 1], zero, zero
    if C == 2:
        return se[..., 0], big, zero, se[..., 1]
    if C == 4:
        if causal:
            raise ValueError("C=4 FlashMask requires causal=False")
        return se[..., 0], se[..., 1], se[..., 2], se[..., 3]
    raise ValueError(f"startend_row_indices last dim must be 1, 2 or 4, "
                     f"got {C}")


def band_hidden(bands, Sq: int, Sk: int, causal: bool):
    """[B, Hm, Sq, Sk] bool, True where the bands (or the top-left causal
    diagonal) hide key j from row i: the dense mask, for the plain version
    and the composite route only."""
    s1, e1, s2, e2 = (t[:, :, None, :] for t in bands)
    rows = torch.arange(Sq, device=s1.device)[:, None]
    hid = ((rows >= s1) & (rows < e1)) | ((rows >= s2) & (rows < e2))
    if causal:
        hid = hid | (torch.arange(Sk, device=s1.device)[None, :] > rows)
    return hid


def flashmask_block_kinds(bands, Sq: int, Sk: int, bq: int, bk: int,
                          causal: bool):
    """[B, Hm, nq, nk] int32 skip map at bq x bk tiles: 0 where the tile
    contributes nothing (above the causal diagonal, or one band of every
    column of the tile covers all of its rows), else 1. The reference's map
    (equal to it at 128 x 128 for lengths it divides); ragged last tiles
    count their real rows and columns only. At 64 x 64 it is the skip rule
    of the Hopper kernels' forward."""
    s1, e1, s2, e2 = bands
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    lo, hi = torch.iinfo(torch.int32).min, torch.iinfo(torch.int32).max

    def per_tile(a, red, fill):
        a = F.pad(a, (0, nk * bk - Sk), value=fill)
        return red(a.reshape(*a.shape[:-1], nk, bk), dim=-1)[..., None, :]

    dev = s1.device
    q0 = torch.arange(nq, device=dev)[:, None] * bq             # [nq, 1]
    q1 = (q0 + bq).clamp_max(Sq)
    full1 = ((per_tile(s1, torch.amax, lo) <= q0)
             & (per_tile(e1, torch.amin, hi) >= q1))
    full2 = ((per_tile(s2, torch.amax, lo) <= q0)
             & (per_tile(e2, torch.amin, hi) >= q1))
    masked = full1 | full2
    if causal:
        masked = masked | (q1 <= torch.arange(nk, device=dev)[None, :] * bk)
    return (~masked).to(torch.int32)


def flashmask_kernel_eligible(Sq: int, Sk: int, D: int, block_q: int = 128,
                              block_k: int = 128) -> bool:
    """Shapes the Hopper kernels take: head_dim 64 or 128 and at least one
    row and one key. The tiles mask their ragged edges, so no length needs
    to divide a block; `block_q` / `block_k` are the TPU's tiling, accepted
    for the JAX signature only."""
    return Sq >= 1 and Sk >= 1 and D in HEAD_DIMS


def check_shapes(q, k, v, se):
    """Raise on shapes no route takes (on every device)."""
    name = "flashmask_sdpa"
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected [B, S, H, D]")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in B or D")
    if k.shape[2] != H:
        raise ValueError(f"{name}: k / v have {k.shape[2]} heads and q {H}; "
                         f"FlashMask takes no grouped-query attention: "
                         f"repeat k and v to q's heads first")
    if se.dim() != 4 or se.shape[0] != B or se.shape[1] not in (1, H) \
            or se.shape[2] != k.shape[1]:
        raise ValueError(f"{name}: startend_row_indices {tuple(se.shape)}; "
                         f"expected [B={B}, 1 or H={H}, Sk={k.shape[1]}, C]")


def _check_kernel(q, k, v):
    """Raise on what the kernels do not take; the head dim first, so that a
    refused one names its ROADMAP entry whatever the device."""
    name = "flashmask_sdpa"
    Sq, D = q.shape[1], q.shape[-1]
    if not flashmask_kernel_eligible(Sq, k.shape[1], D):
        raise ValueError(
            f"{name}: head_dim {D}, Sq {Sq}, Sk {k.shape[1]}: the Hopper "
            f"kernels take head_dim {HEAD_DIMS} and S >= 1; the head dims "
            f"above 128 that the TPU kernel takes are ROADMAP.md queue A, "
            f"A2b")
    dev = q.device
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise TypeError(f"{name}: q, k and v share one dtype")
    _build.dtype_code(q)


def _band_tensor(se, Sq, Sk, causal, device):
    """The bands as the kernels read them: int32 [B, Hm, Sk, 4]."""
    return torch.stack(bands_from_startend(se.to(device), Sq, Sk, causal),
                       dim=-1).contiguous()


def _stats(bands):
    """The kernels' per-tile band workspace: int32 [B, Hm, nk, 8]."""
    B, Hm, Sk, _ = bands.shape
    return torch.empty(B, Hm, -(-Sk // TILE), 8, dtype=torch.int32,
                       device=bands.device)


def _reference_fwd(q, k, v, se, causal, scale):
    Sq, Sk = q.shape[1], k.shape[1]
    bands = bands_from_startend(se.to(q.device), Sq, Sk, causal)
    return masked_attention(q, k, v, band_hidden(bands, Sq, Sk, causal),
                            scale)


def flashmask_sdpa_reference(q, k, v, startend_row_indices,
                             causal: bool = True,
                             scale: Optional[float] = None,
                             block_q: int = 128, block_k: int = 128):
    """Plain version of `flashmask_sdpa`: a dense f32 softmax over the band
    mask (top-left causal), with the kernels' zero rows, differentiable by
    autograd."""
    check_shapes(q, k, v, startend_row_indices)
    return _reference_fwd(q, k, v, startend_row_indices, causal, scale)[0]


def flashmask_sdpa_bwd_reference(q, k, v, do, startend_row_indices,
                                 causal: bool = True,
                                 scale: Optional[float] = None):
    """Plain version of the backward: (dq, dk, dv) of
    `flashmask_sdpa_reference` for the output gradient `do`, by autograd."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = flashmask_sdpa_reference(qq, kk, vv, startend_row_indices,
                                     causal, scale)
        return torch.autograd.grad(o, (qq, kk, vv), do)


def _launch_fwd(q, k, v, bands, causal, scale):
    B, Sq, H, D = q.shape
    Sk, Hm = k.shape[1], bands.shape[1]
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    stats = _stats(bands)
    fn = _build.kernel("ptt_flashmask_fwd", [_P] * 7 + [_I] * 6
                       + [_P, _I, _F, _I, _I, _P])
    strides = _strides(q, k, v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bands.data_ptr(),
             stats.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Hm, Sq,
             Sk, D, ctypes.addressof(strides), int(causal), float(scale),
             _build.dtype_code(q), q.device.index or 0, _build.stream(q))
    _build.check("flashmask_sdpa", err)
    flashmask_sdpa.launches += 1
    return out, lse


def _launch_bwd(q, k, v, bands, o, lse, do, causal, scale):
    B, Sq, H, D = q.shape
    Sk, Hm = k.shape[1], bands.shape[1]
    o = o.contiguous()
    do = do.to(q.dtype).contiguous()
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("flashmask_sdpa_bwd: o / do must be [B, Sq, H, D] "
                         "and lse f32 [B, H, Sq]")
    lse = lse.contiguous()
    di = torch.empty_like(lse)
    dq = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    dk = torch.empty(B, Sk, H, D, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = _stats(bands)
    fn = _build.kernel("ptt_flashmask_bwd", [_P] * 12 + [_I] * 6
                       + [_P, _I, _F, _I, _I, _P])
    strides = _strides(q, k, v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bands.data_ptr(),
             stats.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
             di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
             Hm, Sq, Sk, D, ctypes.addressof(strides), int(causal),
             float(scale), _build.dtype_code(q), q.device.index or 0,
             _build.stream(q))
    _build.check("flashmask_sdpa_bwd", err)
    flashmask_sdpa_bwd.launches += 1
    return dq, dk, dv


def flashmask_sdpa_bwd(q, k, v, o, lse, do, startend_row_indices,
                       causal: bool = True, scale: Optional[float] = None):
    """(dq, dk, dv) of `flashmask_sdpa` for the output gradient `do`, given
    the forward's output `o` and its f32 logsumexp `lse` [B, H, Sq]. On
    CUDA one call launches the tile pre-pass, di, dq and dkv; on CPU
    tensors the plain version (autograd of `flashmask_sdpa_reference`; `o`
    and `lse` unused)."""
    check_shapes(q, k, v, startend_row_indices)
    if q.device.type == "cpu":
        flashmask_sdpa_bwd.plain_calls += 1
        return flashmask_sdpa_bwd_reference(q, k, v, do,
                                            startend_row_indices, causal,
                                            scale)
    _check_kernel(q, k, v)
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    bands = _band_tensor(startend_row_indices, Sq, Sk, causal, q.device)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    return _launch_bwd(q, k, v, bands, o, lse, do, causal, scale)


class _FlashMaskFn(torch.autograd.Function):
    """The kernels' forward and backward (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, bands, causal, scale):
        o, lse = _launch_fwd(q, k, v, bands, causal, scale)
        ctx.save_for_backward(q, k, v, bands, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bands, o, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, bands, o, lse, do, ctx.causal,
                                 ctx.scale)
        return dq, dk, dv, None, None, None


def flashmask_sdpa(q, k, v, startend_row_indices, causal: bool = True,
                   scale: Optional[float] = None, block_q: int = 128,
                   block_k: int = 128):
    """[B, S, H, D] FlashMask attention; differentiable. `block_q` /
    `block_k` are the TPU kernel's tiling and do not steer the Hopper tiles
    (64 x 64, fixed in the source). On CUDA, a shape
    `flashmask_kernel_eligible` refuses raises ValueError."""
    if _build.faked(q, k, v, startend_row_indices):
        return flashmask_sdpa_reference(q, k, v, startend_row_indices,
                                        causal, scale)
    if q.device.type == "cpu":
        flashmask_sdpa.plain_calls += 1
        return flashmask_sdpa_reference(q, k, v, startend_row_indices,
                                        causal, scale)
    check_shapes(q, k, v, startend_row_indices)
    _check_kernel(q, k, v)
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    bands = _band_tensor(startend_row_indices, Sq, Sk, causal, q.device)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    return _FlashMaskFn.apply(q, k, v, bands, bool(causal), float(scale))


flashmask_sdpa.launches = 0
flashmask_sdpa.plain_calls = 0
flashmask_sdpa_bwd.launches = 0
flashmask_sdpa_bwd.plain_calls = 0


register_oracle(
    "flashmask_sdpa", kernel=flashmask_sdpa,
    reference=flashmask_sdpa_reference, backward=(flashmask_sdpa_bwd,),
    parity_test="tests/test_torch_flashmask.py::TestFlashMaskParity")
