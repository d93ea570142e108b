"""RMSNorm and rope + paged append (counterpart of paddle_tpu/ops/fused.py).

``fused_rms_norm`` and ``fused_rope_append`` launch the hand-written CUDA
kernels of ``csrc/fused.cu`` on CUDA tensors and run their plain PyTorch
versions (``rms_norm_reference``, ``rope_append_reference``, from
paddle_tpu/ops/references.py) on CPU tensors. A CUDA tensor launches the
kernel or raises; nothing falls back. Each wrapper counts its kernel
launches in ``.launches`` and its plain-version calls in
``.plain_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["fused_rms_norm", "rms_norm_reference", "fused_rope_append",
           "rope_append_reference"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# ---------------------------------------------------------------------------
# rms_norm
# ---------------------------------------------------------------------------

def rms_norm_reference(x, weight, eps: float = 1e-6):
    """Plain version: f32 statistics, x * rsqrt(mean(x^2) + eps) * w."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def fused_rms_norm(x, weight, eps: float = 1e-6):
    """x [..., H] rms-normalized in f32 and scaled by weight [H] (f32 or
    x's dtype); returns x's dtype."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        fused_rms_norm.plain_calls += 1
        return rms_norm_reference(x, weight, eps)
    dev = _build.require_cuda("fused_rms_norm", x, weight)
    H = x.shape[-1]
    if weight.shape != (H,):
        raise ValueError(f"fused_rms_norm: weight {tuple(weight.shape)} "
                         f"for rows of width {H}")
    T = x.numel() // H if H else 0
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    use_vec = int(H % vec == 0 and x.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
    fn = _build.kernel("ptt_rms_norm",
                       [_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _P])
    err = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), T, H,
             float(eps), _build.dtype_code(x), _build.dtype_code(weight),
             use_vec, dev.index or 0, _build.stream(x))
    _build.check("fused_rms_norm", err)
    fused_rms_norm.launches += 1
    return out


fused_rms_norm.launches = 0
fused_rms_norm.plain_calls = 0


# ---------------------------------------------------------------------------
# rope + paged-cache append (serving decode path; inference only)
# ---------------------------------------------------------------------------

def _rotate_half(x, c, s):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_append_reference(q, k, v, cos, sin, k_pages, v_pages,
                          page_idx, page_off):
    """Plain version of `fused_rope_append` (same in-place contract)."""
    P, psz = k_pages.shape[1], k_pages.shape[2]
    c = cos.float()[:, None, :]                       # [T, 1, D/2]
    s = sin.float()[:, None, :]
    qr = _rotate_half(q.float(), c, s).to(q.dtype)
    kr = _rotate_half(k.float(), c, s)
    pg = page_idx.long().clamp(0, P - 1)
    off = page_off.long().clamp(0, psz - 1)
    k_pages[:, pg, off, :] = kr.to(k_pages.dtype).transpose(0, 1)
    v_pages[:, pg, off, :] = v.to(v_pages.dtype).transpose(0, 1)
    return qr, k_pages, v_pages


def fused_rope_append(q, k, v, cos, sin, k_pages, v_pages,
                      page_idx, page_off):
    """Rotary embedding (per-token cos/sin rows, half-split convention)
    on q and k, plus the paged-cache K/V row scatter, in one launch.

    q [T, Hq, D]; k/v [T, KV, D]; cos/sin [T, D/2] (f32); k/v_pages
    [KV, total_pages, page_size, D]; page_idx/page_off [T] name where
    token t's K/V row lands (clamped into the pool, so a sentinel -1
    page lands on the trash page 0). Returns (q_roped, k_pages,
    v_pages): the pools are the SAME tensors that were passed, updated
    in place — the JAX kernel aliased them (input_output_aliases); a
    PyTorch tensor is mutable, so the port writes the rows into the
    caller's pools and allocates only q_roped."""
    if q.device.type == "cpu":
        fused_rope_append.plain_calls += 1
        return rope_append_reference(q, k, v, cos, sin, k_pages, v_pages,
                                     page_idx, page_off)
    name = "fused_rope_append"
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    dev = _build.require_cuda(name, q, k, v, cos, sin, k_pages, v_pages)
    T, Hq, D = q.shape
    KV = k.shape[1]
    P, psz = k_pages.shape[1], k_pages.shape[2]
    if (k.shape != (T, KV, D) or v.shape != (T, KV, D) or D % 2
            or cos.shape != (T, D // 2) or sin.shape != (T, D // 2)
            or k_pages.shape != (KV, P, psz, D)
            or v_pages.shape != k_pages.shape):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} cos {tuple(cos.shape)} pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if len({q.dtype, k.dtype, v.dtype, k_pages.dtype, v_pages.dtype}) != 1:
        raise TypeError(f"{name}: q, k, v and the pools share one dtype")
    pg = _build.index32(name, page_idx, dev)
    off = _build.index32(name, page_off, dev)
    if pg.shape != (T,) or off.shape != (T,):
        raise ValueError(f"{name}: page_idx/page_off must be [T={T}]")
    q_out = torch.empty_like(q)
    fn = _build.kernel("ptt_rope_append", [_P] * 10 + [_I] * 8 + [_P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
             sin.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             pg.data_ptr(), off.data_ptr(), q_out.data_ptr(), T, Hq, KV, D,
             P, psz, _build.dtype_code(q), dev.index or 0, _build.stream(q))
    _build.check(name, err)
    fused_rope_append.launches += 1
    return q_out, k_pages, v_pages


fused_rope_append.launches = 0
fused_rope_append.plain_calls = 0


register_oracle(
    "fused_rms_norm", kernel=fused_rms_norm, reference=rms_norm_reference,
    parity_test="tests/test_torch_ops.py::TestRmsNormParity")
register_oracle(
    "fused_rope_append", kernel=fused_rope_append,
    reference=rope_append_reference,
    parity_test="tests/test_torch_ops.py::TestRopeAppendParity")
