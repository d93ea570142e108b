"""o-proj -> residual -> rms or layer norm, and the whole SwiGLU or
tanh-GELU FFN, one wrapper call each (counterpart of
paddle_tpu/ops/pallas_megadecode.py: the fp, int8 and packed-int4
weight sites).

``fused_oproj_norm`` and ``fused_ffn`` launch the hand-written CUDA
kernels of ``csrc/megakernels.cu`` on CUDA tensors and run their plain
PyTorch versions ``oproj_norm_reference`` / ``megadecode_ffn_reference``
(from paddle_tpu/ops/references.py) on CPU tensors. A CUDA tensor
launches the kernels or raises; nothing falls back. Each wrapper counts
``.launches`` once per call, although a call issues more than one CUDA
kernel: ``fused_oproj_norm`` two (a split-K tensor-core GEMM into f32
partials, then one block per row for residual + norm), ``fused_ffn``
three (gate/up GEMM with the activation epilogue, split-K down GEMM,
then the residual add). The wrappers allocate the workspaces and pick
the split of K (``_build.split_k``). As in the JAX package, the packed
int4 layout takes swiglu only: an int4 gelu FFN raises
NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..nn.functional import gelu
from . import _build
from .oracles import register_oracle
from .quant import INT4, WFMT, check_algo, dequant_matmul_f32

__all__ = ["fused_oproj_norm", "oproj_norm_reference", "fused_ffn",
           "megadecode_ffn_reference", "megadecode_eligible"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


NORMS = {"rms": 0, "layer": 1}
ACTS = {"swiglu": 0, "gelu": 1}


def _check_norm(norm: str, algo) -> None:
    check_algo(algo)
    if norm not in NORMS:
        raise ValueError(f"fused_oproj_norm: norm {norm!r}: expected "
                         "'rms' or 'layer'")


def _check_act(act: str, algo) -> None:
    check_algo(algo)
    if act not in ACTS:
        raise ValueError(f"fused_ffn: act {act!r}: expected 'swiglu' or "
                         "'gelu'")
    if act == "gelu" and algo == INT4:
        raise NotImplementedError("int4 fused_ffn is swiglu-only")



def _f32(t, n: int, dev):
    """An optional [n] vector as contiguous f32 on `dev` (exact upcast)."""
    return None if t is None else t.reshape(n).to(dev, torch.float32)


# ---------------------------------------------------------------------------
# o-proj + residual + norm
# ---------------------------------------------------------------------------

def oproj_norm_reference(o, x, w, scale=None, bias=None, norm_weight=None,
                         norm_bias=None, *, eps: float = 1e-6,
                         norm: str = "rms", algo: Optional[str] = None):
    """Plain version: f32 o-proj (+ bias; the JAX kernels' op order for
    int8 / int4 weights) + residual, rms or layer norm of the f32 sum
    (`_norm_f32`'s op order); returns (x_new, h) in x's dtype."""
    _check_norm(norm, algo)
    shape = x.shape
    H = shape[-1]
    x2 = x.reshape(-1, H).float()
    o2 = o.reshape(x2.shape[0], -1)
    p = dequant_matmul_f32(o2, w, scale, algo)
    if bias is not None:
        p = p + bias.reshape(1, H).float()
    xn = x2 + p
    if norm == "rms":
        var = (xn * xn).mean(-1, keepdim=True)
        y = xn * torch.rsqrt(var + eps)
    else:
        xc = xn - xn.mean(-1, keepdim=True)
        var = (xc * xc).mean(-1, keepdim=True)
        y = xc * torch.rsqrt(var + eps)
    if norm_weight is not None:
        y = y * norm_weight.reshape(1, H).float()
    if norm_bias is not None:
        y = y + norm_bias.reshape(1, H).float()
    return xn.to(x.dtype).reshape(shape), y.to(x.dtype).reshape(shape)


def fused_oproj_norm(o, x, w, scale=None, bias=None, norm_weight=None,
                     norm_bias=None, *, eps: float = 1e-6, norm: str = "rms",
                     algo: Optional[str] = None):
    """o-proj -> (+bias) -> residual add -> rms (``norm="rms"``) or layer
    (``norm="layer"``) norm.

    ``o`` [..., Ko] is the attention output, ``x`` [..., H] the residual
    stream, ``w`` / ``scale`` the o-proj weight in any deploy layout: fp
    [Ko, H] (``algo`` None, ``scale`` ignored, as in the JAX package),
    int8 [Ko, H] + f32 scale [H] ('weight_only_int8') or packed int4
    [Ko/2, H] + scale [H] ('weight_only_int4'); bias / norm_weight /
    norm_bias [H] or None. Returns ``(x_new, h)``, both shaped like
    ``x``: the post-residual stream and its normed copy (the FFN input),
    the norm taken on the f32 sum, not on the rounded x_new."""
    name = "fused_oproj_norm"
    _check_norm(norm, algo)
    if x.device.type == "cpu":
        fused_oproj_norm.plain_calls += 1
        return oproj_norm_reference(o, x, w, scale, bias, norm_weight,
                                    norm_bias, eps=eps, norm=norm,
                                    algo=algo)
    shape = x.shape
    H = shape[-1]
    x2 = x.reshape(-1, H)
    T = x2.shape[0]
    o2 = o.reshape(T, -1)
    Ko = o2.shape[1]
    dev = _build.require_cuda(name, o2, x2, w)
    if w.shape != (Ko // 2 if algo == INT4 else Ko, H):
        raise ValueError(f"{name}: o {tuple(o.shape)}, x {tuple(shape)}, "
                         f"{algo or 'fp'} w {tuple(w.shape)}")
    if not megadecode_eligible(H, 8, Ko, dtype_bytes=x.element_size()):
        raise ValueError(f"{name}: the kernel takes Ko and H multiples of "
                         f"8; got Ko {Ko}, H {H}")
    if o.dtype != x.dtype:
        raise TypeError(f"{name}: o and x share one dtype")
    # f32 copies held until the launch is enqueued (a temporary freed
    # earlier would hand its memory to the next one)
    s = _build.weight_layout(name, algo, w, scale, H, x.dtype, dev)
    _build.require_aligned(name, o2, w)
    per, splits = _build.split_k(T, H, Ko, x)
    partial = torch.empty(splits, T, H, dtype=torch.float32, device=dev)
    x_new, h = torch.empty_like(x2), torch.empty_like(x2)
    b, nw, nb = (_f32(v, H, dev) for v in (bias, norm_weight, norm_bias))
    fn = _build.kernel("ptt_oproj_norm",
                       [_P] * 10 + [_I] * 5 + [_F, _I, _I, _I, _I, _P])
    err = fn(o2.data_ptr(), x2.data_ptr(), w.data_ptr(), _build.ptr(s),
             _build.ptr(b), _build.ptr(nw), _build.ptr(nb),
             partial.data_ptr(), x_new.data_ptr(), h.data_ptr(), T, Ko, H,
             per, splits, float(eps), NORMS[norm], WFMT[algo],
             _build.dtype_code(x), dev.index or 0, _build.stream(x))
    _build.check(name, err)
    fused_oproj_norm.launches += 1
    return x_new.reshape(shape), h.reshape(shape)


fused_oproj_norm.launches = 0
fused_oproj_norm.plain_calls = 0


# ---------------------------------------------------------------------------
# gate/up + swiglu (or gate + gelu) + down + residual
# ---------------------------------------------------------------------------

def megadecode_ffn_reference(h, x, wg, sg=None, wu=None, su=None, wd=None,
                             sd=None, b1=None, b2=None, *,
                             act: str = "swiglu",
                             algo: Optional[str] = None):
    """Plain version: gate/up, g * sigmoid(g) * u (or gate + b1 and the
    tanh-GELU of `nn.functional.gelu`, `wu` unread), down, b2 and the
    residual, all in f32 (the JAX kernels' op order for int8 / int4
    weights: int4 splits h, and the activation before the down product,
    into even and odd columns); returns x's dtype and shape."""
    _check_act(act, algo)
    shape = x.shape
    H = shape[-1]
    x2 = x.reshape(-1, H).float()
    h2 = h.reshape(-1, H)
    g = dequant_matmul_f32(h2, wg, sg, algo)
    if b1 is not None:
        g = g + b1.reshape(1, -1).float()
    if act == "swiglu":
        t = g * torch.sigmoid(g) * dequant_matmul_f32(h2, wu, su, algo)
    else:
        t = gelu(g, approximate=True)
    d = dequant_matmul_f32(t, wd, sd, algo)
    if b2 is not None:
        d = d + b2.reshape(1, H).float()
    return (x2 + d).to(x.dtype).reshape(shape)


def fused_ffn(h, x, wg, sg=None, wu=None, su=None, wd=None, sd=None,
              b1=None, b2=None, *, act: str = "swiglu",
              algo: Optional[str] = None):
    """Gate/up matmul -> swiglu (or gate matmul -> gelu) -> down-proj ->
    residual add.

    ``h`` [..., H] is the normed FFN input (fused_oproj_norm's second
    output), ``x`` [..., H] the residual stream (its first); weights in
    any deploy layout as in :func:`fused_oproj_norm`: fp wg/wu [H, I],
    wd [I, H] (scales ignored); int8 the same shapes + f32 scales sg/su
    [I], sd [H]; packed int4 wg/wu [H/2, I], wd [I/2, H] + the scales;
    b1 [I] / b2 [H] or None. Returns x + down(silu(h @ wg + b1) * (h @
    wu)) + b2, or with ``act="gelu"`` x + down(gelu(h @ wg + b1)) + b2
    (``wu`` / ``su`` ignored and may be None; not int4), shaped like
    ``x``."""
    name = "fused_ffn"
    _check_act(act, algo)
    gelu = act == "gelu"
    if gelu:
        wu = su = None
    if x.device.type == "cpu":
        fused_ffn.plain_calls += 1
        return megadecode_ffn_reference(h, x, wg, sg, wu, su, wd, sd, b1,
                                        b2, act=act, algo=algo)
    shape = x.shape
    H = shape[-1]
    x2 = x.reshape(-1, H)
    h2 = h.reshape(-1, H)
    T = x2.shape[0]
    I = wg.shape[-1]
    ups = (wg,) if gelu else (wg, wu)
    dev = _build.require_cuda(name, h2, x2, *ups, wd)
    pack = 2 if algo == INT4 else 1
    if (h2.shape != x2.shape or wg.shape != (H // pack, I)
            or any(w_.shape != wg.shape for w_ in ups)
            or wd.shape != (I // pack, H)):
        raise ValueError(f"{name}: h {tuple(h.shape)}, x {tuple(shape)}, "
                         f"{algo or 'fp'} {act} wg {tuple(wg.shape)}, wu "
                         f"{None if gelu else tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}")
    if not megadecode_eligible(H, I, 8, dtype_bytes=x.element_size()):
        raise ValueError(f"{name}: the kernel takes H and I multiples of "
                         f"8; got H {H}, I {I}")
    if h.dtype != x.dtype:
        raise TypeError(f"{name}: h and x share one dtype")
    fsg, fsu = (None if w_ is None else
                _build.weight_layout(name, algo, w_, s_, I, x.dtype, dev)
                for w_, s_ in ((wg, sg), (wu, su)))
    fsd = _build.weight_layout(name, algo, wd, sd, H, x.dtype, dev)
    _build.require_aligned(name, h2, *ups, wd)
    # the f32 activation as the down GEMM reads it: f32, or bf16 hi + lo
    planes = 2 if x.dtype == torch.bfloat16 else 1
    work = torch.empty(planes, T, I, dtype=x.dtype, device=dev)
    per, splits = _build.split_k(T, H, I, x)
    partial = torch.empty(splits, T, H, dtype=torch.float32, device=dev)
    out = torch.empty_like(x2)
    fb1, fb2 = _f32(b1, I, dev), _f32(b2, H, dev)
    fn = _build.kernel("ptt_ffn", [_P] * 13 + [_I] * 9 + [_P])
    err = fn(h2.data_ptr(), x2.data_ptr(), wg.data_ptr(), _build.ptr(wu),
             wd.data_ptr(), _build.ptr(fsg), _build.ptr(fsu),
             _build.ptr(fsd), _build.ptr(fb1), _build.ptr(fb2),
             work.data_ptr(), partial.data_ptr(), out.data_ptr(), T, H, I,
             per, splits, ACTS[act], WFMT[algo], _build.dtype_code(x),
             dev.index or 0, _build.stream(x))
    _build.check(name, err)
    fused_ffn.launches += 1
    return out.reshape(shape)


fused_ffn.launches = 0
fused_ffn.plain_calls = 0


def megadecode_eligible(hidden: int, intermediate: int, o_width: int, *,
                        dtype_bytes: int = 2, device=None) -> bool:
    """True when the kernels take this geometry (the engine's gate for
    the fused back half, a pure function of shapes). On the CPU the
    plain versions take any geometry: True. On the card, from what the
    kernels need: 16-byte copies of every activation row and 4-column
    epilogue stores of whole 8-column groups (hidden, intermediate and
    o_width multiples of 8, which covers bf16 and f32 and makes every
    packed int4 contraction even) and an activation of 2 or 4 bytes.
    int8 and int4 weight rows take 16-byte copies where their width is a
    multiple of 16, byte copies else (right, slower), so the weight
    layout adds no rule. No size limit: the weights stream through
    shared memory and the activation goes through a workspace (the TPU's
    VMEM rule does not apply)."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    return (dtype_bytes in (2, 4)
            and min(hidden, intermediate, o_width) > 0
            and hidden % 8 == 0 and intermediate % 8 == 0
            and o_width % 8 == 0)


register_oracle(
    "fused_oproj_norm", kernel=fused_oproj_norm,
    reference=oproj_norm_reference,
    parity_test="tests/test_torch_megakernels.py::TestOprojNormParity")
register_oracle(
    "fused_ffn", kernel=fused_ffn, reference=megadecode_ffn_reference,
    parity_test="tests/test_torch_megakernels.py::TestFfnParity")
