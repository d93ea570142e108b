"""RMSNorm, LayerNorm, rope + paged append and the paged row append
(counterpart of paddle_tpu/ops/fused.py).

``fused_rms_norm``, ``fused_layer_norm``, ``fused_rope_append`` and
``fused_append_rows`` launch the hand-written CUDA kernels of
``csrc/fused.cu`` on CUDA tensors and run their plain PyTorch versions
(``rms_norm_reference``, ``layer_norm_reference``,
``rope_append_reference``, from paddle_tpu/ops/references.py, and
``append_rows_reference``) on CPU tensors. A CUDA tensor launches the
kernel or raises; nothing falls back. Each wrapper counts its kernel
launches in ``.launches`` and its plain-version calls in
``.plain_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["fused_rms_norm", "rms_norm_reference", "fused_layer_norm",
           "layer_norm_reference", "fused_rope_append",
           "rope_append_reference", "fused_append_rows",
           "append_rows_reference"]

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
# layer_norm (scale and bias)
# ---------------------------------------------------------------------------

def layer_norm_reference(x, weight, bias, eps: float = 1e-5):
    """Plain version: the f32 mean, the centred variance mean((x -
    mu)^2), then (x - mu) * rsqrt(var + eps) * w + b in f32 and one cast
    to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def fused_layer_norm(x, weight, bias, eps: float = 1e-5):
    """x [..., H] layer-normalized in f32, scaled by weight [H] and
    shifted by bias [H] (both f32 or both x's dtype); returns x's
    dtype."""
    name = "fused_layer_norm"
    if x.device.type == "cpu" and weight.device.type == "cpu" \
            and bias.device.type == "cpu":
        fused_layer_norm.plain_calls += 1
        return layer_norm_reference(x, weight, bias, eps)
    dev = _build.require_cuda(name, x, weight, bias)
    H = x.shape[-1]
    if weight.shape != (H,) or bias.shape != (H,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)} for rows of width {H}")
    if weight.dtype != bias.dtype:
        raise TypeError(f"{name}: weight and bias share one dtype")
    T = x.numel() // H if H else 0
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    use_vec = int(H % vec == 0 and x.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
    fn = _build.kernel("ptt_layer_norm",
                       [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _P])
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             out.data_ptr(), T, H, float(eps), _build.dtype_code(x),
             _build.dtype_code(weight), use_vec, dev.index or 0,
             _build.stream(x))
    _build.check(name, err)
    fused_layer_norm.launches += 1
    return out


fused_layer_norm.launches = 0
fused_layer_norm.plain_calls = 0


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


# ---------------------------------------------------------------------------
# paged row append (the MLA engine's latent rows)
# ---------------------------------------------------------------------------

def append_rows_reference(pages, rows, page_idx, page_off):
    """Plain version of `fused_append_rows` (same in-place contract)."""
    P, psz = pages.shape[1], pages.shape[2]
    pg = page_idx.long().clamp(0, P - 1)
    off = page_off.long().clamp(0, psz - 1)
    pages[:, pg, off, :] = rows.to(pages.dtype).transpose(0, 1)
    return pages


def fused_append_rows(pages, rows, page_idx, page_off):
    """Scatter per-token cache rows [T, KV, D] into the paged pools
    [KV, total_pages, page_size, D] at (page_idx[t], page_off[t]), both
    clamped into the pool (idle rows land on the trash page 0, where
    duplicates are allowed). The MLA engine's latent-row append: its rope
    runs on the split q_pe / k_pe shapes before the rows are
    concatenated. Returns ``pages``, the SAME tensor, updated in place
    (the JAX kernel aliased it through input_output_aliases)."""
    if pages.device.type == "cpu":
        fused_append_rows.plain_calls += 1
        return append_rows_reference(pages, rows, page_idx, page_off)
    name = "fused_append_rows"
    rows = rows.contiguous()
    dev = _build.require_cuda(name, pages, rows)
    T, KV, D = rows.shape
    P, psz = pages.shape[1], pages.shape[2]
    if pages.shape != (KV, P, psz, D):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} into pages "
                         f"{tuple(pages.shape)}")
    if rows.dtype != pages.dtype:
        raise TypeError(f"{name}: rows and pages share one dtype")
    pg = _build.index32(name, page_idx, dev)
    off = _build.index32(name, page_off, dev)
    if pg.shape != (T,) or off.shape != (T,):
        raise ValueError(f"{name}: page_idx/page_off must be [T={T}]")
    row_bytes = D * rows.element_size()
    vec = int(row_bytes % 16 == 0 and rows.data_ptr() % 16 == 0
              and pages.data_ptr() % 16 == 0)
    fn = _build.kernel("ptt_append_rows", [_P] * 4 + [_I] * 8 + [_P])
    err = fn(pages.data_ptr(), rows.data_ptr(), pg.data_ptr(),
             off.data_ptr(), T, KV, D, P, psz, vec, _build.dtype_code(rows),
             dev.index or 0, _build.stream(rows))
    _build.check(name, err)
    fused_append_rows.launches += 1
    return pages


fused_append_rows.launches = 0
fused_append_rows.plain_calls = 0


register_oracle(
    "fused_rms_norm", kernel=fused_rms_norm, reference=rms_norm_reference,
    parity_test="tests/test_torch_ops.py::TestRmsNormParity")
register_oracle(
    "fused_layer_norm", kernel=fused_layer_norm,
    reference=layer_norm_reference,
    parity_test="tests/test_torch_gpt.py::TestLayerNormParity")
register_oracle(
    "fused_rope_append", kernel=fused_rope_append,
    reference=rope_append_reference,
    parity_test="tests/test_torch_ops.py::TestRopeAppendParity")
register_oracle(
    "fused_append_rows", kernel=fused_append_rows,
    reference=append_rows_reference,
    parity_test="tests/test_torch_deepseek.py::TestAppendRowsParity")
