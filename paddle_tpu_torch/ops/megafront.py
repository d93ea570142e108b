"""qkv projection -> rope -> paged K/V append in one wrapper call
(counterpart of paddle_tpu/ops/pallas_megafront.py: the fp, int8 and
packed-int4 weight sites).

``fused_qkv_rope_append`` launches the hand-written CUDA kernels of
``csrc/megakernels.cu`` on CUDA tensors (two CUDA kernels per call,
counted as one launch: a split-K tensor-core GEMM into f32 partials,
then one thread per rope pair that sums them, adds the bias, ropes q and
k on the f32 sum and writes each token's K/V row into the pools) and
runs its plain PyTorch version ``qkv_rope_append_reference`` (from
paddle_tpu/ops/references.py) on CPU tensors. A CUDA tensor launches the
kernel or raises; nothing falls back. The wrapper counts
``.launches`` and ``.plain_calls``.

The MLA layout (``lora_rank > 0``) is ROADMAP.md queue A item 5 and
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .fused import _rotate_half
from .oracles import register_oracle
from .quant import INT4, WFMT, check_algo, dequant_matmul_f32

__all__ = ["fused_qkv_rope_append", "qkv_rope_append_reference",
           "megafront_eligible"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def _refuse(algo, lora_rank) -> None:
    check_algo(algo)
    if lora_rank:
        raise NotImplementedError(
            "fused_qkv_rope_append: the MLA layout (lora_rank > 0) is not "
            "ported yet (ROADMAP.md queue A item 5)")


def qkv_rope_append_reference(h, w, scale, bias, cos, sin, k_pages,
                              v_pages, page_idx, page_off, *, heads: int,
                              kv_heads: int = 0, head_dim: int = 0,
                              algo: Optional[str] = None, norm_weight=None,
                              eps: float = 1e-6, nope_dim: int = 0,
                              rope_dim: int = 0, lora_rank: int = 0):
    """Plain version: f32 projection (+ bias), rope on the f32 q and k,
    then the K/V rows into the pools in place (same contract as the
    kernel). The projection takes the JAX kernels' op order: int8
    ``h @ (q * s)``, int4 the even / odd columns of h against the scaled
    nibble planes."""
    _refuse(algo, lora_rank)
    T = h.shape[0]
    D = head_dim
    P, psz = k_pages.shape[1], k_pages.shape[2]
    p = dequant_matmul_f32(h, w, scale, algo)
    if bias is not None:
        p = p + bias.reshape(1, -1).float()
    c = cos.float()[:, None, :]                        # [T, 1, D/2]
    s = sin.float()[:, None, :]
    q = p[:, :heads * D].reshape(T, heads, D)
    k = p[:, heads * D:(heads + kv_heads) * D].reshape(T, kv_heads, D)
    v = p[:, (heads + kv_heads) * D:].reshape(T, kv_heads, D)
    qr = _rotate_half(q, c, s).to(h.dtype)
    kr = _rotate_half(k, c, s)
    pg = page_idx.long().clamp(0, P - 1)
    off = page_off.long().clamp(0, psz - 1)
    k_pages[:, pg, off, :] = kr.to(k_pages.dtype).transpose(0, 1)
    v_pages[:, pg, off, :] = v.to(v_pages.dtype).transpose(0, 1)
    return qr, k_pages, v_pages


def fused_qkv_rope_append(h, w, scale, bias, cos, sin, k_pages, v_pages,
                          page_idx, page_off, *, heads: int,
                          kv_heads: int = 0, head_dim: int = 0,
                          algo: Optional[str] = None, norm_weight=None,
                          eps: float = 1e-6, nope_dim: int = 0,
                          rope_dim: int = 0, lora_rank: int = 0):
    """qkv projection -> rope -> paged K/V append.

    ``h`` [T, H] is the normed hidden stream; ``w`` / ``scale`` the
    concatenated slab, N = (heads + 2 * kv_heads) * head_dim, columns
    [q | k | v], in any deploy layout: fp [H, N] (``algo`` None,
    ``scale`` ignored, as in the JAX package), int8 [H, N] + f32 scale
    [N] ('weight_only_int8'), or packed int4 [H/2, N] + scale [N]
    ('weight_only_int4'); ``bias`` [N] or None (zeros); cos/sin [T,
    head_dim / 2]; k/v_pages [kv_heads, total_pages, page_size,
    head_dim]; page_idx / page_off [T] name where token t's K/V row
    lands, clamped into the pool (page 0 is the trash page idle rows
    write to). Returns
    ``(q_roped [T, heads, head_dim], k_pages, v_pages)``: the pools are
    the SAME tensors, updated in place (the JAX kernel aliased them)."""
    _refuse(algo, lora_rank)
    if h.device.type == "cpu":
        fused_qkv_rope_append.plain_calls += 1
        return qkv_rope_append_reference(
            h, w, scale, bias, cos, sin, k_pages, v_pages, page_idx,
            page_off, heads=heads, kv_heads=kv_heads, head_dim=head_dim,
            algo=algo)
    name = "fused_qkv_rope_append"
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    dev = _build.require_cuda(name, h, w, cos, sin, k_pages, v_pages)
    T, H = h.shape
    D, KV = head_dim, kv_heads
    N = (heads + 2 * KV) * D
    P, psz = k_pages.shape[1], k_pages.shape[2]
    rows = H // 2 if algo == INT4 else H
    if (w.shape != (rows, N) or cos.shape != (T, D // 2)
            or sin.shape != (T, D // 2)
            or k_pages.shape != (KV, P, psz, D)
            or v_pages.shape != k_pages.shape):
        raise ValueError(
            f"{name}: h {tuple(h.shape)} w {tuple(w.shape)} cos "
            f"{tuple(cos.shape)} pages {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)} for heads {heads}/{KV} x {D}")
    if not megafront_eligible(H, N, D, dtype_bytes=h.element_size()):
        raise ValueError(
            f"{name}: the kernel takes H and N multiples of 8 and an even "
            f"head_dim; got H {H}, N {N}, head_dim {D}")
    s = _build.weight_layout(name, algo, w, scale, N, h.dtype, dev)
    if len({h.dtype, k_pages.dtype, v_pages.dtype}) != 1:
        raise TypeError(f"{name}: h and the pools share one dtype")
    _build.require_aligned(name, h, w)
    b = None if bias is None else bias.reshape(N).to(dev, torch.float32)
    pg = _build.index32(name, page_idx, dev)
    off = _build.index32(name, page_off, dev)
    if pg.shape != (T,) or off.shape != (T,):
        raise ValueError(f"{name}: page_idx/page_off must be [T={T}]")
    q_out = torch.empty(T, heads, D, dtype=h.dtype, device=dev)
    per, splits = _build.split_k(T, N, H, h)
    partial = torch.empty(splits, T, N, dtype=torch.float32, device=dev)
    fn = _build.kernel("ptt_qkv_rope_append", [_P] * 12 + [_I] * 12 + [_P])
    err = fn(h.data_ptr(), w.data_ptr(), _build.ptr(s), _build.ptr(b),
             cos.data_ptr(), sin.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), pg.data_ptr(), off.data_ptr(),
             q_out.data_ptr(), partial.data_ptr(), T, H, heads, KV, D, P,
             psz, per, splits, WFMT[algo], _build.dtype_code(h),
             dev.index or 0, _build.stream(h))
    _build.check(name, err)
    fused_qkv_rope_append.launches += 1
    return q_out, k_pages, v_pages


fused_qkv_rope_append.launches = 0
fused_qkv_rope_append.plain_calls = 0


def megafront_eligible(hidden: int, out_cols: int, head_dim: int, *,
                       dtype_bytes: int = 2, device=None) -> bool:
    """True when the kernel takes this geometry (the engine's gate for
    the fused front half, a pure function of shapes). On the CPU the
    plain version takes any geometry: True. On the card, from what the
    kernels need: 16-byte copies of h rows (hidden a multiple of 8, which
    covers bf16 and f32; it also makes the packed int4 contraction even),
    4-column epilogue stores of whole 8-column groups (out_cols a
    multiple of 8), whole heads of an even head_dim (rope pairs j with j
    + head_dim / 2) and an activation of 2 or 4 bytes. int8 and int4
    weight rows take 16-byte copies where out_cols is a multiple of 16,
    byte copies else (right, slower), so the weight layout adds no rule.
    No size limit: the weights stream through shared memory, never
    resident (the TPU's VMEM rule does not apply)."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    return (dtype_bytes in (2, 4) and hidden > 0
            and hidden % 8 == 0 and out_cols % 8 == 0
            and head_dim > 0 and head_dim % 2 == 0
            and out_cols % head_dim == 0)


register_oracle(
    "fused_qkv_rope_append", kernel=fused_qkv_rope_append,
    reference=qkv_rope_append_reference,
    parity_test="tests/test_torch_megakernels.py::TestQkvRopeAppendParity")
