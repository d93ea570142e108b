"""o-proj -> residual -> rms or layer norm, and the whole SwiGLU or
tanh-GELU FFN, one wrapper call each (counterpart of
paddle_tpu/ops/pallas_megadecode.py: the fp, int8 and packed-int4
weight sites).

``fused_oproj_norm`` and ``fused_ffn`` launch hand-written CUDA kernels
on CUDA tensors and run their plain PyTorch versions
``oproj_norm_reference`` / ``megadecode_ffn_reference`` (from
paddle_tpu/ops/references.py) on CPU tensors. A CUDA tensor launches the
kernels or raises; nothing falls back. bf16 runs ``csrc/megadecode_sm90.cu``
(wgmma on the transposed product, TMA, K slices merged in the same
launch); f32 runs ``csrc/megakernels.cu``'s GEMM core. Each wrapper
counts ``.launches`` once per call, although a call issues two CUDA
kernels (bf16: ``fused_oproj_norm`` the o-proj into an f32 [T, H] sum,
then a block a row for residual + norm; ``fused_ffn`` gate/up with the
activation epilogue into bf16 hi + lo planes, then down + b2 + residual)
or, f32, two and three. The wrappers allocate every workspace and take
the launch plan from the library (bf16: ``ptt_md_plan``; f32:
``_build.split_k``). As in the JAX package, the packed int4 layout takes
swiglu only: an int4 gelu FFN raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..nn.functional import gelu
from . import _build
from .oracles import register_oracle
from . import quant
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


def md_plan(M: int, N: int, K: int, wfmt: int, pair: bool, planes: int,
            dev: torch.device):
    """The bf16 kernel's launch plan for an [M, K] x [K, N] product
    (``pair``: swiglu's gate and up; ``planes`` 2: the down product's hi
    + lo): (token tile, K slices, chunks a slice, split counters, f32
    partials)."""
    out = (ctypes.c_int * 5)()
    fn = _build.kernel("ptt_md_plan", [_I] * 7 + [_P])
    _build.check("ptt_md_plan", fn(M, N, K, wfmt, int(pair), planes,
                                   dev.index or 0, ctypes.addressof(out)))
    return tuple(out)


def _vectors(ns, dev, *vs):
    """Optional vectors of lengths `ns` (one int for all) as the bf16
    kernels read them: as they are where every given one is bf16 (flag
    1; read exactly as f32), else f32 copies (flag 0)."""
    ns = ns if isinstance(ns, tuple) else (ns,) * len(vs)
    given = [v for v in vs if v is not None]
    if given and all(v.dtype == torch.bfloat16 for v in given):
        return (1, *(None if v is None else v.reshape(n).to(dev).contiguous()
                     for v, n in zip(vs, ns)))
    return (0, *(_f32(v, n, dev) for v, n in zip(vs, ns)))


def _workspaces(t: torch.Tensor, *plans):
    """The f32 partials (the largest any plan needs) and the stream's
    split counters for launches of `plans` on t's stream, or None."""
    n_part = max(pl[4] for pl in plans)
    n_cnt = max(pl[3] for pl in plans)
    if not n_part:
        return None, None
    return (torch.empty(n_part, dtype=torch.float32, device=t.device),
            quant._split_counters(n_cnt, t))


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
    if x.dtype == torch.bfloat16:
        x_new, h = _oproj_norm_bf16(o2, x2, w, s, bias, norm_weight,
                                    norm_bias, eps, norm, algo)
        fused_oproj_norm.launches += 1
        return x_new.reshape(shape), h.reshape(shape)
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32 or bfloat16, got {x.dtype}")
    b, nw, nb = (_f32(v, H, dev) for v in (bias, norm_weight, norm_bias))
    per, splits = _build.split_k(T, H, Ko, x)
    partial = torch.empty(splits, T, H, dtype=torch.float32, device=dev)
    x_new, h = torch.empty_like(x2), torch.empty_like(x2)
    fn = _build.kernel("ptt_oproj_norm",
                       [_P] * 10 + [_I] * 5 + [_F, _I, _I, _I, _P])
    err = fn(o2.data_ptr(), x2.data_ptr(), w.data_ptr(), _build.ptr(s),
             _build.ptr(b), _build.ptr(nw), _build.ptr(nb),
             partial.data_ptr(), x_new.data_ptr(), h.data_ptr(), T, Ko, H,
             per, splits, float(eps), NORMS[norm], WFMT[algo],
             dev.index or 0, _build.stream(x))
    _build.check(name, err)
    fused_oproj_norm.launches += 1
    return x_new.reshape(shape), h.reshape(shape)


def _oproj_norm_bf16(o2, x2, w, s, bias, norm_weight, norm_bias,
                     eps: float, norm: str, algo):
    """The bf16 kernels of csrc/megadecode_sm90.cu: (x_new, h) [T, H]."""
    T, Ko = o2.shape
    H = x2.shape[1]
    dev = x2.device
    if x2.data_ptr() % 16:           # the norm reads x 16 bytes at a time
        x2 = x2.clone()
    vbf, b, nw, nb = _vectors(H, dev, bias, norm_weight, norm_bias)
    wfmt = WFMT[algo]
    _nt, n_ks, per, _c, _p = plan = md_plan(T, H, Ko, wfmt, False, 1, dev)
    partial, counters = _workspaces(x2, plan)
    total = torch.empty(T, H, dtype=torch.float32, device=dev)
    x_new, h = torch.empty_like(x2), torch.empty_like(x2)
    fn = _build.kernel("ptt_md_oproj_norm",
                       [_P] * 7 + [_I] + [_P] * 5 + [_I] * 5
                       + [_F, _I, _I, _I, _P])
    err = fn(o2.data_ptr(), x2.data_ptr(), w.data_ptr(), _build.ptr(s),
             _build.ptr(b), _build.ptr(nw), _build.ptr(nb), vbf,
             total.data_ptr(), _build.ptr(partial), _build.ptr(counters),
             x_new.data_ptr(), h.data_ptr(), T, Ko, H, per, n_ks,
             float(eps), NORMS[norm], wfmt, dev.index or 0,
             _build.stream(x2))
    _check_split("fused_oproj_norm", err, counters, x2)
    return x_new, h


def _check_split(name: str, err: int, counters, t) -> None:
    """Raise on a refused launch; a refused split may leave counts behind,
    so the next split on this stream takes fresh zeros. (A kernel that
    faults on the card leaves the context unusable, and every later call
    fails.)"""
    if err and counters is not None:
        quant._counters.pop((t.device.index or 0, _build.stream(t)), None)
    _build.check(name, err)


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
    if x.dtype == torch.bfloat16:
        out = _ffn_bf16(h2, x2, wg, fsg, wu, fsu, wd, fsd, b1, b2, gelu,
                        algo)
        fused_ffn.launches += 1
        return out.reshape(shape)
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32 or bfloat16, got {x.dtype}")
    fb1, fb2 = _f32(b1, I, dev), _f32(b2, H, dev)
    work = torch.empty(1, T, I, dtype=x.dtype, device=dev)
    per, splits = _build.split_k(T, H, I, x)
    partial = torch.empty(splits, T, H, dtype=torch.float32, device=dev)
    out = torch.empty_like(x2)
    fn = _build.kernel("ptt_ffn", [_P] * 13 + [_I] * 8 + [_P])
    err = fn(h2.data_ptr(), x2.data_ptr(), wg.data_ptr(), _build.ptr(wu),
             wd.data_ptr(), _build.ptr(fsg), _build.ptr(fsu),
             _build.ptr(fsd), _build.ptr(fb1), _build.ptr(fb2),
             work.data_ptr(), partial.data_ptr(), out.data_ptr(), T, H, I,
             per, splits, ACTS[act], WFMT[algo], dev.index or 0,
             _build.stream(x))
    _build.check(name, err)
    fused_ffn.launches += 1
    return out.reshape(shape)


def _ffn_bf16(h2, x2, wg, sg, wu, su, wd, sd, b1, b2, gelu: bool, algo):
    """The bf16 kernels of csrc/megadecode_sm90.cu: out [T, H]. The f32
    activation reaches the down product as the bf16 hi + lo planes of one
    [2, T, I] workspace."""
    T, H = x2.shape
    I = wg.shape[1]
    dev = x2.device
    wfmt = WFMT[algo]
    if x2.data_ptr() % 16:           # the residual is read 8 bytes at a time
        x2 = x2.clone()
    vbf, b1, b2 = _vectors((I, H), dev, b1, b2)
    pu = md_plan(T, I, H, wfmt, not gelu, 1, dev)
    pd = md_plan(T, H, I, wfmt, False, 2, dev)
    partial, counters = _workspaces(x2, pu, pd)
    act = torch.empty(2, T, I, dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x2)
    fn = _build.kernel("ptt_md_ffn",
                       [_P] * 10 + [_I] + [_P] * 4 + [_I] * 10 + [_P])
    err = fn(h2.data_ptr(), x2.data_ptr(), wg.data_ptr(), _build.ptr(wu),
             wd.data_ptr(), _build.ptr(sg), _build.ptr(su), _build.ptr(sd),
             _build.ptr(b1), _build.ptr(b2), vbf, act.data_ptr(),
             _build.ptr(partial), _build.ptr(counters), out.data_ptr(), T,
             H, I, pu[2], pu[1], pd[2], pd[1], int(gelu), wfmt,
             dev.index or 0, _build.stream(x2))
    _check_split("fused_ffn", err, counters, x2)
    return out


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
