"""Weight-only quantized linear, int8 and packed int4 (counterpart of
paddle_tpu/ops/quant.py).

The deploy layouts, byte for byte the JAX package's:

- int8: ``weight_quantize(w)`` -> (int8 [K, N], f32 scale [N]), the
  symmetric absmax of each output column over 127, values
  round-half-even of ``w / max(scale, 1e-8)`` clipped to +-127;
- int4: (int8 [K/2, N], f32 scale [N]), absmax over 7, values in +-7,
  source rows 2i and 2i + 1 packed into the low and high nibble of byte
  row i.

``weight_only_linear`` launches the hand-written CUDA kernel of
``csrc/megakernels.cu`` on CUDA tensors (the megakernels' GEMM core with
an int8 / int4 weight loader, split K, then a pass that sums the f32
partials and applies the per-column scale) and runs its plain PyTorch
version ``weight_only_linear_reference`` on CPU tensors. A CUDA tensor
launches the kernel or raises; nothing falls back. The wrapper counts
``.launches`` and ``.plain_calls``. Its gradient in x is the JAX custom
VJP's plain formula ``g @ dequant(W)^T`` (not a kernel in JAX either).

``int4_dequantize`` (the MLA absorbed kv_b's whole read) is ROADMAP.md
queue B, with the MLA slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["weight_quantize", "weight_dequantize", "int4_planes",
           "weight_only_linear", "weight_only_linear_reference",
           "dequant_matmul_f32", "ALGOS"]

INT8, INT4 = "weight_only_int8", "weight_only_int4"
ALGOS = (INT8, INT4)
#: the kernels' weight-format codes (ptt::mega::WFmt in megakernels.cu)
WFMT = {None: 0, INT8: 1, INT4: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int


def check_algo(algo: Optional[str]) -> None:
    """Raise on a weight layout name that is none of fp, int8, int4."""
    if algo is not None and algo not in ALGOS:
        raise ValueError(f"unknown algo: {algo}")


def _to_int8(v: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 256) as the int8 of the same byte."""
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def weight_quantize(w, algo: str = INT8):
    """w [K, N] -> (quantized weight, per-channel f32 scale [N]).
    int8: symmetric absmax; int4: packed two nibbles per int8 byte."""
    check_algo(algo)
    wf = w.float()
    absmax = wf.abs().amax(0)
    top = 127.0 if algo == INT8 else 7.0
    scale = absmax / top
    q = torch.clamp(torch.round(wf / torch.clamp_min(scale, 1e-8)), -top,
                    top)
    if algo == INT8:
        return q.to(torch.int8), scale
    if q.shape[0] % 2:
        raise ValueError("int4 pack needs even K")
    qi = q.to(torch.int32)
    # the nibble shifts in int32, then the byte as int8
    return _to_int8((qi[0::2] & 0xF) | ((qi[1::2] & 0xF) << 4)), scale


def int4_planes(qw):
    """Sign-extended nibble planes of a packed int4 weight: (lo, hi) int8
    [K/2, N], lo = the even source rows, hi = the odd ones."""
    q = qw.to(torch.int32)
    lo = ((q & 0xF) ^ 8) - 8
    hi = q >> 4                          # arithmetic: sign-extends
    return lo.to(torch.int8), hi.to(torch.int8)


def weight_dequantize(qw, scale, algo: str = INT8):
    """The f32 weight [K, N] of a deploy layout."""
    check_algo(algo)
    s = scale.reshape(1, -1).float()
    if algo == INT8:
        return qw.float() * s
    lo, hi = int4_planes(qw)
    K2, N = qw.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N).float() * s


def dequant_matmul_f32(x2, w, scale, algo: Optional[str]):
    """f32 x2 [M, K] @ the f32 weight of any deploy layout, in the op order
    of the JAX Pallas kernels: fp ``x @ w``; int8 ``x @ (q * s)``; int4
    ``x[:, 0::2] @ (lo * s) + x[:, 1::2] @ (hi * s)`` (the even / odd
    split contraction of _wol4_kernel and the megakernels' int4 sites)."""
    check_algo(algo)
    x2 = x2.float()
    if algo is None:
        return x2 @ w.float()
    s = scale.reshape(1, -1).float()
    if algo == INT8:
        return x2 @ (w.float() * s)
    lo, hi = int4_planes(w)
    return x2[:, 0::2] @ (lo.float() * s) + x2[:, 1::2] @ (hi.float() * s)


def weight_only_linear_reference(x, qweight, scale, bias=None,
                                 algo: str = INT8):
    """Plain version: the whole weight dequantized, a dense f32 product
    (int4 in the JAX kernel's split order), the result in x's dtype."""
    shape = x.shape
    out = dequant_matmul_f32(x.reshape(-1, shape[-1]), qweight, scale,
                             algo).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out.reshape(*shape[:-1], out.shape[-1])


def _launch(x2, qw, scale, algo: str):
    """out [M, N] = x2 @ dequant(qw) on the card (the CUDA kernel)."""
    name = "weight_only_linear"
    dev = _build.require_cuda(name, x2, qw, scale)
    M, K = x2.shape
    N = qw.shape[1]
    if qw.dtype != torch.int8 or scale.shape != (N,) \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name}: int8 weight and f32 [N] scale, got "
                        f"{qw.dtype} and {scale.dtype} {tuple(scale.shape)}")
    if qw.shape[0] * (2 if algo == INT4 else 1) != K:
        raise ValueError(f"{name}: x {tuple(x2.shape)} against {algo} "
                         f"weight {tuple(qw.shape)}")
    vec = 16 // x2.element_size()
    if K % vec:
        raise ValueError(f"{name}: the kernel copies x rows in 16-byte "
                         f"pieces: K must be a multiple of {vec}, got {K}")
    out = torch.empty(M, N, dtype=x2.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    _build.require_aligned(name, x2)
    per, splits = _build.split_k(M, N, K, x2)
    partial = torch.empty(splits, M, N, dtype=torch.float32, device=dev)
    fn = _build.kernel("ptt_weight_only_linear", [_P] * 5 + [_I] * 8 + [_P])
    err = fn(x2.data_ptr(), qw.data_ptr(), scale.data_ptr(),
             partial.data_ptr(), out.data_ptr(), M, N, K, per, splits,
             WFMT[algo], _build.dtype_code(x2), dev.index or 0,
             _build.stream(x2))
    _build.check(name, err)
    return out


class _WeightOnlyLinear(torch.autograd.Function):
    """x2 [M, K] @ dequant(W): the kernel (or, on the CPU, its plain
    version) forward; backward in x only, g @ dequant(W)^T in f32."""

    @staticmethod
    def forward(ctx, x2, qweight, scale, algo):
        ctx.save_for_backward(qweight, scale)
        ctx.algo = algo
        if x2.device.type == "cpu":
            weight_only_linear.plain_calls += 1
            return weight_only_linear_reference(x2, qweight, scale,
                                                algo=algo)
        out = _launch(x2, qweight, scale.reshape(-1).float().contiguous(),
                      algo)
        weight_only_linear.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        qweight, scale = ctx.saved_tensors
        w = weight_dequantize(qweight, scale, ctx.algo)
        return (g.float() @ w.T).to(g.dtype), None, None, None


def weight_only_linear(x, qweight, scale, bias=None, algo: str = INT8):
    """x [..., K] @ dequant(qweight) + bias.

    ``qweight`` int8 [K, N] (``algo`` 'weight_only_int8') or packed int4
    [K/2, N] ('weight_only_int4'), ``scale`` [N]; any leading shape of
    x, any M and N (the kernel masks its ragged edges; rows whose bytes
    are no multiple of 16 take byte copies). The product comes back in
    x's dtype; the bias is added after it, as in the JAX package."""
    check_algo(algo)
    if algo is None:
        raise ValueError("weight_only_linear takes an int8 or int4 weight")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    out = _WeightOnlyLinear.apply(x2, qweight, scale, algo)
    if bias is not None:
        out = out + bias
    return out.reshape(*shape[:-1], out.shape[-1])


weight_only_linear.launches = 0
weight_only_linear.plain_calls = 0


register_oracle(
    "weight_only_linear", kernel=weight_only_linear,
    reference=weight_only_linear_reference,
    parity_test="tests/test_torch_quant.py::TestWeightOnlyLinearParity")
