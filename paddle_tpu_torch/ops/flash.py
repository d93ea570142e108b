"""Flash attention, forward and backward (counterpart of
paddle_tpu/ops/pallas_flash.py).

`flash_sdpa` takes ``[B, S, H, D]`` q / k / v, optional causal masking
(bottom-right aligned: key j is visible to row i iff
``j <= i + (Sk - Sq)``) and optional ``[B, S]`` segment ids (rows and keys
of different segments do not see each other). On CUDA tensors it runs the
hand-written kernels of ``csrc/flash_attention.cu`` through
`torch.autograd.Function`: the forward kernel writes ``o`` and an f32
logsumexp, and `flash_sdpa_bwd` launches the lse / di pre-pass, the
fused backward and dq's conversion. On CPU tensors it runs the plain version
`flash_sdpa_reference`, which autograd differentiates. A CUDA tensor
launches the kernels or raises; nothing falls back.

bf16 runs Hopper kernels (wgmma products, TMA tile loads completed on
mbarriers, two warpgroups a block; ``csrc/flash_sm90.cuh``). The forward
takes 128 q rows a block against K / V tiles of 128 keys (96 at head_dim
192). The backward takes 128 keys a block against 64-row Q / dO tiles
and does the five products in one kernel; its dq tiles are summed in f32
by bulk reduce-adds into a workspace of ``B * H * ceil(Sq / 64) * 64 *
(D + 2)`` floats (136 MB at B 1, S 8192, 32 heads of 128), allocated
zeroed for the call, so dq's summation order, and its last bits, vary
from run to run. f32 runs a scalar path (di, dq and dkv kernels) that
holds the plain version at 2e-5.

The forward launch is the operator ``paddle_tpu_torch::flash_fwd``
(``torch.library.custom_op``), so ``torch.export`` records attention as
one node of the exported program, which launches the kernel when the
program runs on the card (``jit.save`` / ``inference.Predictor``).

The forward takes head_dim 64, 128 and 192 (the MLA prefill), the
backward 64 and 128 (`BWD_HEAD_DIMS`; 192 raises, naming its ROADMAP
item).

A row that sees no key comes out as zeros (lse = +1e30), where a dense
softmax would average v; its gradients are zero, never NaN.

Counts: ``flash_sdpa.launches`` counts forward kernels,
``flash_sdpa_bwd.launches`` backward calls (each three CUDA kernels:
bf16 the lse / di pre-pass, the fused backward and dq's conversion; f32
di, dq and dkv); ``.plain_calls`` the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["flash_sdpa", "flash_sdpa_bwd", "flash_sdpa_reference",
           "flash_sdpa_bwd_reference", "flash_kernel_eligible"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_NEG = -1e30
#: head dims the forward kernel is built for (192: the MLA prefill's
#: q / k of DeepSeek-V2, dn + dr = 128 + 64, v padded to it)
HEAD_DIMS = (64, 128, 192)
#: head dims the backward kernels are built for; 192 (MLA training) is
#: ROADMAP.md queue A item 5c's rest
BWD_HEAD_DIMS = (64, 128)


def flash_kernel_eligible(Sq: int, Sk: int, D: int, block_q: int = 128,
                          block_k: int = 128) -> bool:
    """Shapes the Hopper forward kernel takes: head_dim 64, 128 or 192
    and at least one row and one key (the backward takes 64 and 128:
    `flash_sdpa_bwd`). The kernels mask their ragged tiles, so no length
    needs to divide a block; `block_q` / `block_k` are the TPU's tiling and
    are accepted for the JAX signature only."""
    return Sq >= 1 and Sk >= 1 and D in HEAD_DIMS


def _refuse_bwd_dim(D: int) -> None:
    if D not in BWD_HEAD_DIMS:
        raise ValueError(
            f"flash_sdpa_bwd: head_dim {D} has a forward kernel only; the "
            f"backward takes {BWD_HEAD_DIMS} (head_dim 192, MLA training, is "
            f"ROADMAP.md queue A item 5c's rest)")


def _segments(B, Sq, Sk, segment_ids_q, segment_ids_kv, device):
    """(seg_q, seg_kv) as int32 [B, Sq] / [B, Sk], or (None, None) without
    segments; a missing side is all ones (the JAX wrapper's default)."""
    if segment_ids_q is None and segment_ids_kv is None:
        return None, None
    ones = lambda n: torch.ones(B, n, dtype=torch.int32,  # noqa: E731
                                device=device)
    sq = ones(Sq) if segment_ids_q is None else segment_ids_q
    skv = ones(Sk) if segment_ids_kv is None else segment_ids_kv
    return (sq.to(device, torch.int32).contiguous(),
            skv.to(device, torch.int32).contiguous())


def _hidden(B, Sq, Sk, causal, seg_q, seg_kv, device):
    """[B, 1, Sq, Sk] bool: key hidden from row."""
    hid = torch.zeros(1, 1, Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        rows = torch.arange(Sq, device=device)[:, None]
        cols = torch.arange(Sk, device=device)[None, :]
        hid = hid | (cols > rows + (Sk - Sq))
    if seg_q is not None:
        hid = hid | (seg_q[:, None, :, None] != seg_kv[:, None, None, :])
    return hid.expand(B, 1, Sq, Sk)


def _reference_fwd(q, k, v, causal=False, segment_ids_q=None,
                   segment_ids_kv=None, scale=None):
    """(o, lse [B, H, Sq] f32) of the plain version."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    seg_q, seg_kv = _segments(B, Sq, Sk, segment_ids_q, segment_ids_kv,
                              q.device)
    hid = _hidden(B, Sq, Sk, causal, seg_q, seg_kv, q.device)
    return masked_attention(q, k, v, hid, scale)


def masked_attention(q, k, v, hid, scale=None):
    """(o, lse [B, H, Sq] f32): a dense f32 softmax of [B, S, H, D] q / k / v
    with the entries where `hid` ([B, 1 or H, Sq, Sk] bool) is True hidden,
    and the kernels' zero rows (o = 0, lse = +1e30 where no key is
    visible); differentiable by autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(hid, torch.full_like(s, _NEG), s)
    # the max only steadies exp; the result does not depend on it
    m = s.amax(-1, keepdim=True).detach()
    p = torch.where(hid, torch.zeros_like(s), torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float())
    lse = torch.where(empty, torch.full_like(l, -_NEG), m + torch.log(l_safe))
    return o.to(q.dtype), lse[..., 0]


def flash_sdpa_reference(q, k, v, causal: bool = False, segment_ids_q=None,
                         segment_ids_kv=None, scale: Optional[float] = None,
                         block_q: int = 512, block_k: int = 512):
    """Plain version of `flash_sdpa`: a dense f32 softmax with the same
    masking and the same zero rows, differentiable by autograd."""
    return _reference_fwd(q, k, v, causal, segment_ids_q, segment_ids_kv,
                          scale)[0]


def flash_sdpa_bwd_reference(q, k, v, do, causal: bool = False,
                             segment_ids_q=None, segment_ids_kv=None,
                             scale: Optional[float] = None):
    """Plain version of the backward: (dq, dk, dv) of
    `flash_sdpa_reference` for the output gradient `do`, by autograd."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = flash_sdpa_reference(qq, kk, vv, causal, segment_ids_q,
                                 segment_ids_kv, scale)
        return torch.autograd.grad(o, (qq, kk, vv), do)


def _strides(*ts):
    """The (batch, seq, head) element strides of q, k, v as int64[9]
    (the caller keeps it alive across the call that reads it)."""
    vals = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * 9)(*vals)


def _kernel_operand(t):
    """`t` as the kernels read it: unit stride along D, rows on 16-byte
    boundaries and no broadcast (zero-stride) dimension (bf16 tiles are
    TMA boxes, whose strides are multiples of 16 bytes); a copy if not."""
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % vec or (s == 0 and n > 1)
                   for s, n in zip(t.stride()[:3], t.shape[:3]))):
        t = t.contiguous()
    return t


def _check(q, k, v, seg_q, seg_kv):
    name = "flash_sdpa"
    dev = q.device
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected [B, S, H, D]")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in B, H or D")
    if not flash_kernel_eligible(Sq, k.shape[1], D):
        raise ValueError(f"{name}: Sq={Sq}, Sk={k.shape[1]}, D={D}; the "
                         f"kernels take head_dim {HEAD_DIMS} and S >= 1 "
                         f"(see flash_kernel_eligible)")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise TypeError(f"{name}: q, k and v share one dtype")
    _build.dtype_code(q)
    if seg_q is not None and (seg_q.shape != (B, Sq)
                              or seg_kv.shape != (B, k.shape[1])):
        raise ValueError(f"{name}: segment ids {tuple(seg_q.shape)} / "
                         f"{tuple(seg_kv.shape)} for B={B}, Sq={Sq}, "
                         f"Sk={k.shape[1]}")


def _launch_fwd(q, k, v, seg_q, seg_kv, causal, scale):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    fn = _build.kernel("ptt_flash_fwd", [_P] * 7 + [_I] * 5 + [_P, _I, _F]
                       + [_I, _I, _P])
    strides = _strides(q, k, v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(seg_q),
             _build.ptr(seg_kv), out.data_ptr(), lse.data_ptr(), B, H, Sq,
             Sk, D, ctypes.addressof(strides), int(causal),
             float(scale), _build.dtype_code(q), q.device.index or 0,
             _build.stream(q))
    _build.check("flash_sdpa", err)
    flash_sdpa.launches += 1
    return out, lse


def _bwd_workspace(B, H, Sq, D, dtype) -> int:
    """f32 elements of the backward's workspace: bf16, dq's sums over
    [B, H, Sq rounded up to 64, D] (zeroed) and the pre-pass's lse and di
    rows [B, H, Sq rounded up to 64] each; f32, di [B, H, Sq] alone."""
    if dtype != torch.bfloat16:
        return B * H * Sq
    rows = B * H * -(-Sq // 64) * 64
    return rows * (D + 2)


def flash_sdpa_bwd(q, k, v, o, lse, do, causal: bool = False,
                   segment_ids_q=None, segment_ids_kv=None,
                   scale: Optional[float] = None):
    """(dq, dk, dv) of `flash_sdpa` for the output gradient `do`, given
    the forward's output `o` and its f32 logsumexp `lse` [B, H, Sq]. On
    CUDA: one call launches three kernels (bf16: the lse / di pre-pass,
    the fused backward, whose bulk reduce-adds make dq's summation order
    vary from run to run, and dq's conversion; f32: di, dq, dkv); on CPU
    tensors the plain version (autograd of `flash_sdpa_reference`; `o`
    and `lse` unused). A head_dim outside BWD_HEAD_DIMS raises on every
    device."""
    _refuse_bwd_dim(q.shape[-1])
    if q.device.type == "cpu":
        flash_sdpa_bwd.plain_calls += 1
        return flash_sdpa_bwd_reference(q, k, v, do, causal, segment_ids_q,
                                        segment_ids_kv, scale)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    seg_q, seg_kv = _segments(B, Sq, Sk, segment_ids_q, segment_ids_kv,
                              q.device)
    _check(q, k, v, seg_q, seg_kv)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    o = o.contiguous()
    do = do.to(q.dtype).contiguous()
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("flash_sdpa_bwd: o / do must be [B, Sq, H, D] and "
                         "lse f32 [B, H, Sq]")
    lse = lse.contiguous()
    di = torch.zeros(_bwd_workspace(B, H, Sq, D, q.dtype),
                     dtype=torch.float32, device=q.device)
    dq = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    dk = torch.empty(B, Sk, H, D, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    fn = _build.kernel("ptt_flash_bwd", [_P] * 12 + [_I] * 5
                       + [_P, _I, _F, _I, _I, _P])
    strides = _strides(q, k, v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(seg_q),
             _build.ptr(seg_kv), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), B, H, Sq, Sk, D,
             ctypes.addressof(strides), int(causal), float(scale),
             _build.dtype_code(q), q.device.index or 0, _build.stream(q))
    _build.check("flash_sdpa_bwd", err)
    flash_sdpa_bwd.launches += 1
    return dq, dk, dv


@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? seg_q, Tensor? seg_kv, "
           "bool causal, float scale) -> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, seg_q, seg_kv, causal, scale):
    """(o, lse) of the forward as ONE operator, ``paddle_tpu_torch::
    flash_fwd``: a program traced by ``torch.export`` holds it as one node
    (its fake implementation gives the shapes), and the node launches the
    kernel when the exported program runs on the card. CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        flash_sdpa.plain_calls += 1
        # contiguous, as the fake implementation (and the kernel) gives
        o, lse = _reference_fwd(q, k, v, causal, seg_q, seg_kv, scale)
        return o.contiguous(), lse.contiguous()
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    return _launch_fwd(q, k, v, seg_q, seg_kv, causal, scale)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, seg_q, seg_kv, causal, scale):
    B, Sq, H, D = q.shape
    return (q.new_empty(B, Sq, H, D),
            q.new_empty(B, H, Sq, dtype=torch.float32))


class _FlashFn(torch.autograd.Function):
    """The kernels' forward and backward (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, scale):
        o, lse = _flash_fwd_op(q, k, v, seg_q, seg_kv, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        dq, dk, dv = flash_sdpa_bwd(q, k, v, o, lse, do, ctx.causal, seg_q,
                                    seg_kv, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_sdpa(q, k, v, causal: bool = False, segment_ids_q=None,
               segment_ids_kv=None, scale: Optional[float] = None,
               block_q: int = 512, block_k: int = 512):
    """[B, S, H, D] flash attention; differentiable. Causal is bottom-right
    aligned for Sq != Sk. `block_q` / `block_k` are the TPU kernel's
    tiling and do not steer the Hopper tiles, fixed in the source: the
    forward 128 q rows by 128 keys (96 at head_dim 192), the backward 128
    keys by 64 q rows. On CUDA, a shape `flash_kernel_eligible` refuses
    raises ValueError; a bf16 launch with scale <= 0 fails (RuntimeError:
    the kernels take the row max over the raw products).

    Without autograd the forward is the operator ``paddle_tpu_torch::
    flash_fwd`` on every device, so a program exported from a model holds
    the same node on the CPU and on the card; on CPU tensors under
    autograd the plain version runs and autograd differentiates it, on
    CUDA tensors the kernels' autograd Function runs."""
    B, Sq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if q.device.type == "cpu" and grad:
        if not _build.faked(q, k, v):
            flash_sdpa.plain_calls += 1
        return flash_sdpa_reference(q, k, v, causal, segment_ids_q,
                                    segment_ids_kv, scale)
    seg_q, seg_kv = _segments(B, Sq, k.shape[1], segment_ids_q,
                              segment_ids_kv, q.device)
    if q.device.type != "cpu":
        _check(q, k, v, seg_q, seg_kv)
    if grad:
        return _FlashFn.apply(q, k, v, seg_q, seg_kv, bool(causal),
                              float(scale))
    return _flash_fwd_op(q, k, v, seg_q, seg_kv, bool(causal),
                         float(scale))[0]


flash_sdpa.launches = 0
flash_sdpa.plain_calls = 0
flash_sdpa_bwd.launches = 0
flash_sdpa_bwd.plain_calls = 0


register_oracle(
    "flash_sdpa", kernel=flash_sdpa, reference=flash_sdpa_reference,
    backward=(flash_sdpa_bwd,),
    parity_test="tests/test_torch_flash.py::TestFlashParity")
