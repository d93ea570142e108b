"""RMSNorm, LayerNorm, rope + paged append, the paged row append, swiglu,
rope, bias + residual + LayerNorm and the MoE dispatch / combine build
(counterpart of paddle_tpu/ops/fused.py).

``fused_rms_norm``, ``fused_layer_norm``, ``fused_rope_append``,
``fused_append_rows``, ``swiglu``, ``fused_rope``,
``fused_bias_residual_layer_norm`` and ``fused_moe_dispatch_combine``
launch the hand-written CUDA kernels of ``csrc/fused.cu`` on CUDA tensors
and run their plain PyTorch versions (``rms_norm_reference``,
``layer_norm_reference``, ``rope_append_reference``, ``swiglu_reference``,
``rope_reference``, ``bias_residual_layer_norm_reference``,
``moe_dispatch_combine_reference``, from paddle_tpu/ops/references.py,
and ``append_rows_reference``) on CPU tensors. A CUDA tensor launches the
kernel or raises; nothing falls back. Each wrapper counts its kernel
launches in ``.launches`` and its plain-version calls in
``.plain_calls``.

The last four are differentiable, as the JAX package's custom VJPs are:
their backwards are torch ops in the JAX backward's op order (the JAX
ones are jnp code), except rope's, which launches the forward kernel
rotating by -theta (``fused_rope_bwd``, counted on its own). Given the
fake tensors of graph capture (``jit.fusion``), a wrapper returns its
plain version's result and counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["fused_rms_norm", "rms_norm_reference", "fused_layer_norm",
           "layer_norm_reference", "fused_rope_append",
           "rope_append_reference", "fused_append_rows",
           "append_rows_reference", "swiglu", "swiglu_reference",
           "fused_rope", "fused_rope_bwd", "rope_reference",
           "fused_bias_residual_layer_norm",
           "bias_residual_layer_norm_reference",
           "fused_moe_dispatch_combine", "moe_dispatch_combine_reference",
           "moe_dc_eligible"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong


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
    if _build.faked(x, weight):
        return rms_norm_reference(x, weight, eps)
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
    if _build.faked(x, weight, bias):
        return layer_norm_reference(x, weight, bias, eps)
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


# ---------------------------------------------------------------------------
# swiglu (differentiable)
# ---------------------------------------------------------------------------

def swiglu_reference(gate, up=None):
    """Plain version: g * logistic(g) * u in f32, one cast to gate's
    dtype; with `up` None the last dim of `gate` splits in half."""
    if up is None:
        d = gate.shape[-1] // 2
        gate, up = gate[..., :d], gate[..., d:]
    gf = gate.float()
    return (gf * torch.sigmoid(gf) * up.float()).to(gate.dtype)


def _rows(t):
    """(t, row stride) with t's rows [.., I] read through one stride (a
    view keeps its storage, e.g. one half of a [.., 2I] row), else a
    contiguous copy."""
    if t.dim() >= 1 and t.stride(-1) == 1:
        if t.dim() == 1:
            return t, t.shape[-1]
        ok = all(t.stride(i) == t.stride(i + 1) * t.shape[i + 1]
                 for i in range(t.dim() - 2))
        if ok:
            return t, t.stride(-2)
    t = t.contiguous()
    return t, t.shape[-1]


def _swiglu_fwd(gate, up):
    if gate.device.type == "cpu" and up.device.type == "cpu":
        swiglu.plain_calls += 1
        return swiglu_reference(gate, up)
    name = "swiglu"
    if gate.shape != up.shape:
        raise ValueError(f"{name}: gate {tuple(gate.shape)} and up "
                         f"{tuple(up.shape)} differ")
    if gate.dtype != up.dtype:
        raise TypeError(f"{name}: gate and up share one dtype")
    g, gs = _rows(gate)
    u, us = _rows(up)
    if g.device != u.device or g.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for devices {g.device} and "
                         f"{u.device}")
    I = g.shape[-1]
    rows = g.numel() // I if I else 0
    out = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    ve = 16 // g.element_size()
    vec = int(I % ve == 0 and gs % ve == 0 and us % ve == 0
              and g.data_ptr() % 16 == 0 and u.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    fn = _build.kernel("ptt_swiglu", [_P, _P, _P, _L, _I, _L, _L, _I, _I,
                                      _I, _P])
    err = fn(g.data_ptr(), u.data_ptr(), out.data_ptr(), rows, I, gs, us,
             vec, _build.dtype_code(g), g.device.index or 0,
             _build.stream(g))
    _build.check(name, err)
    swiglu.launches += 1
    return out


class _SwigluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _swiglu_fwd(gate, up)

    @staticmethod
    def backward(ctx, d):
        # ops/fused.py:539-548 of the JAX package, op for op
        g, u = ctx.saved_tensors
        gf, uf, df = g.float(), u.float(), d.float()
        sig = torch.sigmoid(gf)
        silu = gf * sig
        dsilu = sig * (1 + gf * (1 - sig))
        return (df * uf * dsilu).to(g.dtype), (df * silu).to(u.dtype)


def swiglu(gate, up=None):
    """silu(gate) * up (paddle.incubate.nn.functional.swiglu): with `up`
    None the last dim of `gate` splits in half, both halves read in place
    by the kernel. Differentiable."""
    if up is None:
        d = gate.shape[-1] // 2
        gate, up = gate[..., :d], gate[..., d:]
    if _build.faked(gate, up):
        return swiglu_reference(gate, up)
    return _SwigluFn.apply(gate, up)


swiglu.launches = 0
swiglu.plain_calls = 0


# ---------------------------------------------------------------------------
# rope on q and k (differentiable; the backward launches the kernel too)
# ---------------------------------------------------------------------------

def rope_reference(q, k, cos, sin):
    """Plain version: half-split rope of q [B, S, Hq, D] and k [B, S, Hk,
    D] in f32 with cos / sin [>= S, D/2], one cast each."""
    S = q.shape[1]
    c = cos[:S].float()[None, :, None, :]
    s = sin[:S].float()[None, :, None, :]
    return (_rotate_half(q.float(), c, s).to(q.dtype),
            _rotate_half(k.float(), c, s).to(k.dtype))


def _rope_bwd_reference(gq, gk, cos, sin):
    """The JAX `_rope_bwd` (ops/fused.py:340-348): the rotation by
    -theta in f32, one cast."""
    S = gq.shape[1]
    c = cos[:S].float()[None, :, None, :]
    s = sin[:S].float()[None, :, None, :]

    def rot(g):
        d2 = g.shape[-1] // 2
        g1, g2 = g[..., :d2].float(), g[..., d2:].float()
        return torch.cat([g1 * c + g2 * s, -g1 * s + g2 * c],
                         dim=-1).to(g.dtype)
    return rot(gq), rot(gk)


def _rope_launch(name, q, k, cos, sin, sign: float):
    """One launch over q's rows then k's."""
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    q, k = q.contiguous(), k.contiguous()
    dev = _build.require_cuda(name, q, k, cos, sin)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q, k are [B, S, H, D]")
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    if (k.shape[:2] != (B, S) or k.shape[3] != D or D % 2
            or cos.dim() != 2 or cos.shape[0] < S or cos.shape[1] != D // 2
            or sin.shape != cos.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"cos {tuple(cos.shape)} sin {tuple(sin.shape)}")
    if q.dtype != k.dtype:
        raise TypeError(f"{name}: q and k share one dtype")
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    fn = _build.kernel("ptt_rope", [_P] * 6 + [_I] * 5 + [_F, _I, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
             qo.data_ptr(), ko.data_ptr(), B * S, S, Hq, Hk, D, sign,
             _build.dtype_code(q), dev.index or 0, _build.stream(q))
    _build.check(name, err)
    return qo, ko


def fused_rope_bwd(gq, gk, cos, sin):
    """The rope backward: gq / gk rotated by -theta, by the forward kernel
    with sin negated (exact), in one launch."""
    if gq.device.type == "cpu":
        fused_rope_bwd.plain_calls += 1
        return _rope_bwd_reference(gq, gk, cos, sin)
    out = _rope_launch("fused_rope_bwd", gq, gk, cos, sin, -1.0)
    fused_rope_bwd.launches += 1
    return out


fused_rope_bwd.launches = 0
fused_rope_bwd.plain_calls = 0


class _RopeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        ctx.shapes = (q.shape, q.dtype, k.shape, k.dtype)
        if q.device.type == "cpu":
            fused_rope.plain_calls += 1
            return rope_reference(q, k, cos, sin)
        out = _rope_launch("fused_rope", q, k, cos, sin, 1.0)
        fused_rope.launches += 1
        return out

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        qs, qd, ks, kd = ctx.shapes
        if gq is None:
            gq = torch.zeros(qs, dtype=qd, device=cos.device)
        if gk is None:
            gk = torch.zeros(ks, dtype=kd, device=cos.device)
        dq, dk = fused_rope_bwd(gq, gk, cos, sin)
        return dq, dk, None, None


def fused_rope(q, k, cos, sin):
    """Half-split rotary embedding of q [B, S, Hq, D] and k [B, S, Hk, D]
    with cos / sin [>= S, D/2] (the first S rows), in f32 with one cast:
    (q_rot, k_rot). One launch for both; differentiable in q and k (cos
    and sin are non-differentiable tables, as in the JAX package)."""
    if _build.faked(q, k, cos, sin):
        return rope_reference(q, k, cos, sin)
    return _RopeFn.apply(q, k, cos.detach(), sin.detach())


fused_rope.launches = 0
fused_rope.plain_calls = 0


# ---------------------------------------------------------------------------
# bias + residual + layer_norm (differentiable)
# ---------------------------------------------------------------------------

def bias_residual_layer_norm_reference(x, residual, bias=None, weight=None,
                                       ln_bias=None, eps: float = 1e-5):
    """Plain version: h = x + bias + residual in f32, LayerNorm(h) * w +
    lb (the centred variance) in f32, one cast to x's dtype; absent
    bias / weight / ln_bias are zeros / ones / zeros."""
    H = x.shape[-1]
    b = torch.zeros(H, dtype=x.dtype, device=x.device) if bias is None \
        else bias
    w = torch.ones(H, dtype=x.dtype, device=x.device) if weight is None \
        else weight
    lb = torch.zeros(H, dtype=x.dtype, device=x.device) if ln_bias is None \
        else ln_bias
    h = x.float() + b.float() + residual.float()
    return layer_norm_reference(h, w, lb, eps).to(x.dtype)


def _brln_fwd(x2, r2, b, w, lb, eps):
    name = "fused_bias_residual_layer_norm"
    if x2.device.type == "cpu":
        fused_bias_residual_layer_norm.plain_calls += 1
        return bias_residual_layer_norm_reference(x2, r2, b, w, lb, eps)
    T, H = x2.shape
    if r2.dtype != x2.dtype:
        raise TypeError(f"{name}: x and residual share one dtype")
    if len({b.dtype, w.dtype, lb.dtype}) != 1:
        # one parameter dtype for the kernel; bf16 -> f32 is exact
        b, w, lb = b.float(), w.float(), lb.float()
    x2, r2 = x2.contiguous(), r2.contiguous()
    b, w, lb = b.contiguous(), w.contiguous(), lb.contiguous()
    dev = _build.require_cuda(name, x2, r2, b, w, lb)
    out = torch.empty_like(x2)
    vec = 16 // x2.element_size()
    use_vec = int(H % vec == 0 and x2.data_ptr() % 16 == 0
                  and r2.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    fn = _build.kernel("ptt_bias_residual_ln",
                       [_P] * 6 + [_I, _I, _F, _I, _I, _I, _I, _P])
    err = fn(x2.data_ptr(), r2.data_ptr(), b.data_ptr(), w.data_ptr(),
             lb.data_ptr(), out.data_ptr(), T, H, float(eps),
             _build.dtype_code(x2), _build.dtype_code(w), use_vec,
             dev.index or 0, _build.stream(x2))
    _build.check(name, err)
    fused_bias_residual_layer_norm.launches += 1
    return out


def layer_norm_backward(h, g, w, eps: float):
    """The centred layer norm's backward over the last axis of the f32
    rows `h` [T, H] for the output gradient `g` (ops/fused.py:185-204 of
    the JAX package, op for op): (dh, dw, dlb) in f32."""
    gf = g.float()
    hc = h - h.mean(-1, keepdim=True)
    rstd = torch.rsqrt((hc * hc).mean(-1, keepdim=True) + eps)
    xhat = hc * rstd
    gx = gf * w.float()
    dh = rstd * (gx - gx.mean(-1, keepdim=True)
                 - xhat * (gx * xhat).mean(-1, keepdim=True))
    return dh, (gf * xhat).sum(0), gf.sum(0)


class _BrlnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, r2, b, w, lb, eps):
        ctx.save_for_backward(x2, r2, b, w, lb)
        ctx.eps = eps
        return _brln_fwd(x2, r2, b, w, lb, eps)

    @staticmethod
    def backward(ctx, g):
        x2, r2, b, w, lb = ctx.saved_tensors
        dh, dw, dlb = layer_norm_backward(
            x2.float() + b.float() + r2.float(), g, w, ctx.eps)
        return (dh.to(x2.dtype), dh.to(r2.dtype), dh.sum(0).to(b.dtype),
                dw.to(w.dtype), dlb.to(lb.dtype), None)


def fused_bias_residual_layer_norm(x, residual, bias=None, weight=None,
                                   ln_bias=None, eps: float = 1e-5):
    """layer_norm((x + bias) + residual) * weight + ln_bias in one kernel
    (x, residual [..., H]; bias / weight / ln_bias [H], optional: zeros /
    ones / zeros in x's dtype substituted). Differentiable in all five."""
    shape = x.shape
    H = shape[-1]
    b = torch.zeros(H, dtype=x.dtype, device=x.device) if bias is None \
        else bias
    w = torch.ones(H, dtype=x.dtype, device=x.device) if weight is None \
        else weight
    lb = torch.zeros(H, dtype=x.dtype, device=x.device) if ln_bias is None \
        else ln_bias
    if _build.faked(x, residual, b, w, lb):
        return bias_residual_layer_norm_reference(x, residual, b, w, lb, eps)
    x2 = x.reshape(-1, H)
    r2 = residual.reshape(-1, H)
    if r2.shape != x2.shape or b.shape != (H,) or w.shape != (H,) \
            or lb.shape != (H,):
        raise ValueError(
            f"fused_bias_residual_layer_norm: x {tuple(x.shape)} residual "
            f"{tuple(residual.shape)} bias / weight / ln_bias "
            f"{tuple(b.shape)} / {tuple(w.shape)} / {tuple(lb.shape)}")
    return _BrlnFn.apply(x2, r2, b, w, lb, float(eps)).reshape(shape)


fused_bias_residual_layer_norm.launches = 0
fused_bias_residual_layer_norm.plain_calls = 0


# ---------------------------------------------------------------------------
# MoE dispatch / combine (differentiable)
# ---------------------------------------------------------------------------

#: shared memory a moe_dc block may take: keep, keep * gv and the
#: one-hots of one token as f32 (the default 48 KB a block)
_MOE_DC_SMEM = 48 * 1024


def moe_dc_eligible(k: int, E: int, C: int) -> bool:
    """Whether one token's keep [k, E], keep * gv and one-hots [k, C] fit
    the kernel's shared memory as f32."""
    return 4 * k * (2 * E + C) <= _MOE_DC_SMEM


def moe_dispatch_combine_reference(keep, oh_loc, gv):
    """Plain version: dispatch [T, E, C] = sum_k keep x oh, combine =
    sum_k (keep * gv) x oh, in f32, cast to keep's dtype."""
    kf, of, gf = keep.float(), oh_loc.float(), gv.float()
    disp = torch.einsum("tke,tkc->tec", kf, of)
    comb = torch.einsum("tke,tk,tkc->tec", kf, gf, of)
    return disp.to(keep.dtype), comb.to(keep.dtype)


def _moe_dc_fwd(keep, oh, gv):
    name = "fused_moe_dispatch_combine"
    if keep.device.type == "cpu":
        fused_moe_dispatch_combine.plain_calls += 1
        return moe_dispatch_combine_reference(keep, oh, gv)
    if keep.dim() != 3 or oh.dim() != 3 or gv.dim() != 2:
        raise ValueError(f"{name}: keep [T, k, E], oh [T, k, C], gv [T, k]")
    T, K, E = keep.shape
    C = oh.shape[-1]
    if oh.shape[:2] != (T, K) or gv.shape != (T, K):
        raise ValueError(f"{name}: keep {tuple(keep.shape)} oh "
                         f"{tuple(oh.shape)} gv {tuple(gv.shape)}")
    if not moe_dc_eligible(K, E, C):
        raise ValueError(f"{name}: k {K} x (2E + C) {2 * E + C} f32 "
                         f"exceeds a block's {_MOE_DC_SMEM} bytes")
    out_dtype = keep.dtype
    if len({keep.dtype, oh.dtype, gv.dtype}) != 1:
        # one input dtype for the kernel; the JAX kernel reads each in f32
        keep, oh, gv = keep.float(), oh.float(), gv.float()
    keep, oh, gv = keep.contiguous(), oh.contiguous(), gv.contiguous()
    dev = _build.require_cuda(name, keep, oh, gv)
    disp = torch.empty(T, E, C, dtype=out_dtype, device=dev)
    comb = torch.empty(T, E, C, dtype=out_dtype, device=dev)
    fn = _build.kernel("ptt_moe_dispatch_combine",
                       [_P] * 5 + [_I] * 7 + [_P])
    err = fn(keep.data_ptr(), oh.data_ptr(), gv.data_ptr(), disp.data_ptr(),
             comb.data_ptr(), T, K, E, C, _build.dtype_code(keep),
             _build.dtype_code(out_dtype), dev.index or 0,
             _build.stream(keep))
    _build.check(name, err)
    fused_moe_dispatch_combine.launches += 1
    return disp, comb


class _MoeDcFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, keep, oh, gv):
        ctx.save_for_backward(keep, oh, gv)
        return _moe_dc_fwd(keep, oh, gv)

    @staticmethod
    def backward(ctx, dd, dc):
        # ops/fused.py:277-292 of the JAX package: three einsums
        keep, oh, gv = ctx.saved_tensors
        if dd is None:
            dd = torch.zeros(keep.shape[0], keep.shape[2], oh.shape[2],
                             dtype=keep.dtype, device=keep.device)
        if dc is None:
            dc = torch.zeros_like(dd)
        ddf, dcf = dd.float(), dc.float()
        kf, of, gf = keep.float(), oh.float(), gv.float()
        kg = kf * gf[..., None]
        dkeep = (torch.einsum("tec,tkc->tke", ddf, of)
                 + gf[..., None] * torch.einsum("tec,tkc->tke", dcf, of))
        doh = (torch.einsum("tec,tke->tkc", ddf, kf)
               + torch.einsum("tec,tke->tkc", dcf, kg))
        dgv = torch.einsum("tke,tkc,tec->tk", kf, of, dcf)
        return (dkeep.to(keep.dtype), doh.to(oh.dtype), dgv.to(gv.dtype))


def fused_moe_dispatch_combine(keep, oh_loc, gv):
    """keep [T, k, E], oh_loc [T, k, C], gv [T, k] -> (dispatch [T, E, C],
    combine [T, E, C]) in keep's dtype: the GShard gate's einsum pair in
    one kernel. Differentiable in all three."""
    if _build.faked(keep, oh_loc, gv):
        return moe_dispatch_combine_reference(keep, oh_loc, gv)
    return _MoeDcFn.apply(keep, oh_loc, gv)


fused_moe_dispatch_combine.launches = 0
fused_moe_dispatch_combine.plain_calls = 0


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
register_oracle(
    "swiglu", kernel=swiglu, reference=swiglu_reference,
    parity_test="tests/test_torch_incubate.py::TestSwigluParity")
register_oracle(
    "fused_rope", kernel=fused_rope, reference=rope_reference,
    backward=(fused_rope_bwd,),
    parity_test="tests/test_torch_incubate.py::TestRopeParity")
register_oracle(
    "fused_bias_residual_layer_norm", kernel=fused_bias_residual_layer_norm,
    reference=bias_residual_layer_norm_reference,
    parity_test="tests/test_torch_incubate.py::TestBiasResidualLnParity")
register_oracle(
    "fused_moe_dispatch_combine", kernel=fused_moe_dispatch_combine,
    reference=moe_dispatch_combine_reference,
    parity_test="tests/test_torch_incubate.py::TestMoeDispatchCombineParity")
