"""The grouped GEMM of the MoE experts, forward and backward (counterpart
of paddle_tpu/ops/pallas_gmm.py).

Contract, the JAX kernel's: ``lhs`` [M, K] with rows grouped
contiguously, ``rhs`` [G, K, N], ``group_sizes`` [G] integer with sum
<= M; ``out[m] = lhs[m] @ rhs[g(m)]`` in lhs's dtype, accumulated in
f32; rows past the last group come out zero.

``gmm`` is differentiable, like the JAX custom VJP: a
``torch.autograd.Function`` that saves lhs, rhs and the sizes and
nothing else. Its backward returns
- dlhs = ``gmm_dlhs(dout, rhs, group_sizes)``: the forward's product
  with rhs read as [G, N, K] (no transposed copy is made), tail rows
  zero;
- drhs = ``tgmm(lhs, dout, group_sizes)`` [G, K, N]: for each group g,
  ``lhs[rows of g].T @ dout[rows of g]``; an empty group's slab is zero
  and rows past the last group add nothing;
each in its input's dtype.

On CUDA tensors the three wrappers launch the hand-written CUDA kernels
of ``csrc/gmm.cu``; on CPU tensors they run the plain PyTorch versions
(``gmm_plain`` for the forward, ``gmm_plain(dout, rhs.transpose(1, 2))``
for dlhs, ``tgmm_plain`` for drhs), so the CPU tests check the backward
formula itself, not autograd through a plain version. A CUDA tensor
launches the kernel or raises; nothing falls back. On the card no
wrapper reads back to the host: the group ends are a ``cumsum`` on the
card, every grid comes from the shapes alone and the bf16 kernels find
their work items from the ends on the card, so neither a serving step
nor a training step waits on its routing. Each wrapper counts
``.launches`` and ``.plain_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["gmm", "gmm_dlhs", "tgmm", "gmm_plain", "tgmm_plain",
           "gmm_kernel_eligible"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def _vec(dtype) -> int:
    """Elements of a 16-byte copy."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def gmm_kernel_eligible(K: int, N: int, dtype: torch.dtype) -> bool:
    """The kernels copy rows in 16-byte pieces: K and N multiples of 8
    in bf16, of 4 in f32 (Hopper's gate, the same for the forward and
    both backward kernels; the TPU kernel's K and N multiples of 128 do
    not apply)."""
    return K % _vec(dtype) == 0 and N % _vec(dtype) == 0


def _check(name, lhs, rhs, group_sizes, k_axis: int = 1) -> None:
    """lhs [M, K] against rhs [G, ., .] whose axis `k_axis` is K."""
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(
            f"{name}: lhs [M, K], rhs [G, K, N], group_sizes [G]; got "
            f"{tuple(lhs.shape)}, {tuple(rhs.shape)}, "
            f"{tuple(group_sizes.shape)}")
    if rhs.shape[k_axis] != lhs.shape[1] or \
            group_sizes.shape[0] != rhs.shape[0]:
        raise ValueError(
            f"{name}: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} and "
            f"group_sizes {tuple(group_sizes.shape)} do not agree")
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"{name}: lhs {lhs.dtype} against rhs {rhs.dtype}")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: group_sizes are int32/int64, got "
                        f"{group_sizes.dtype}")


def _check_tgmm(lhs, dout, group_sizes) -> None:
    if lhs.dim() != 2 or dout.dim() != 2 or group_sizes.dim() != 1 or \
            dout.shape[0] != lhs.shape[0]:
        raise ValueError(
            f"tgmm: lhs [M, K], dout [M, N], group_sizes [G]; got "
            f"{tuple(lhs.shape)}, {tuple(dout.shape)}, "
            f"{tuple(group_sizes.shape)}")
    if lhs.dtype != dout.dtype:
        raise TypeError(f"tgmm: lhs {lhs.dtype} against dout {dout.dtype}")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"tgmm: group_sizes are int32/int64, got "
                        f"{group_sizes.dtype}")


def _bounds(group_sizes, M: int):
    """(start, end) row range of each group, clamped to M (host)."""
    start = 0
    for n in group_sizes.tolist():
        end = min(start + max(int(n), 0), M)
        yield start, end
        start = end


def gmm_plain(lhs, rhs, group_sizes):
    """Plain version (the JAX package's ``gmm_reference``, group by
    group): each group's rows times its weight in f32, one cast to lhs's
    dtype; rows past the last group zero. Reads the sizes on the host."""
    _check("gmm", lhs, rhs, group_sizes)
    M = lhs.shape[0]
    out = torch.zeros(M, rhs.shape[2], dtype=lhs.dtype, device=lhs.device)
    for g, (start, end) in enumerate(_bounds(group_sizes, M)):
        if end > start:
            out[start:end] = (lhs[start:end].float()
                              @ rhs[g].float()).to(lhs.dtype)
    return out


def tgmm_plain(lhs, dout, group_sizes):
    """Plain version of drhs: for each group g, ``lhs[rows of g].T @
    dout[rows of g]`` in f32, one cast to lhs's dtype; [G, K, N], an
    empty group's slab zero. Reads the sizes on the host."""
    _check_tgmm(lhs, dout, group_sizes)
    M, K = lhs.shape
    out = torch.zeros(group_sizes.shape[0], K, dout.shape[1],
                      dtype=lhs.dtype, device=lhs.device)
    for g, (start, end) in enumerate(_bounds(group_sizes, M)):
        if end > start:
            out[g] = (lhs[start:end].float().T
                      @ dout[start:end].float()).to(lhs.dtype)
    return out


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _gate(name, K: int, N: int, dtype) -> None:
    if not gmm_kernel_eligible(K, N, dtype):
        raise ValueError(
            f"{name}: the kernel copies rows in 16-byte pieces: K and N "
            f"must be multiples of {_vec(dtype)} for {dtype}, got K={K}, "
            f"N={N}")


def _ends(name, group_sizes, dev):
    return torch.cumsum(_build.index32(name, group_sizes, dev), 0,
                        dtype=torch.int32)


def _launch(name, lhs, rhs, group_sizes, rhs_t: bool):
    """out [M, N] = lhs [M, K] times rhs[g] [K, N], or with `rhs_t` rhs
    [G, N, K] read transposed (dlhs)."""
    dev = _build.require_cuda(name, lhs, rhs)
    M, K = lhs.shape
    G = rhs.shape[0]
    N = rhs.shape[1] if rhs_t else rhs.shape[2]
    _gate(name, K, N, lhs.dtype)
    ends = _ends(name, group_sizes, dev)
    out = torch.empty(M, N, dtype=lhs.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    if G == 0:
        return out.zero_()
    _build.require_aligned(name, lhs, rhs, out)
    fn = _build.kernel("ptt_gmm", [_P] * 4 + [_I] * 7 + [_P])
    err = fn(lhs.data_ptr(), rhs.data_ptr(), ends.data_ptr(),
             out.data_ptr(), M, K, N, G, int(rhs_t), _build.dtype_code(lhs),
             dev.index or 0, _build.stream(lhs))
    _build.check(name, err)
    return out


def _launch_tgmm(lhs, dout, group_sizes):
    name = "tgmm"
    dev = _build.require_cuda(name, lhs, dout)
    M, K = lhs.shape
    N, G = dout.shape[1], group_sizes.shape[0]
    _gate(name, K, N, lhs.dtype)
    ends = _ends(name, group_sizes, dev)
    out = torch.empty(G, K, N, dtype=lhs.dtype, device=dev)
    if G == 0 or K == 0 or N == 0:
        return out
    if M == 0:
        return out.zero_()
    _build.require_aligned(name, lhs, dout, out)
    fn = _build.kernel("ptt_tgmm", [_P] * 4 + [_I] * 6 + [_P])
    err = fn(lhs.data_ptr(), dout.data_ptr(), ends.data_ptr(),
             out.data_ptr(), M, K, N, G, _build.dtype_code(lhs),
             dev.index or 0, _build.stream(lhs))
    _build.check(name, err)
    return out


def gmm_dlhs(dout, rhs, group_sizes):
    """dlhs of gmm: row m of dout [M, N] times rhs[g(m)] [K, N] read as
    [N, K], in dout's dtype with f32 accumulation; rows past the last
    group zero. The kernel reads rhs in place (no transposed copy)."""
    _check("gmm_dlhs", dout, rhs, group_sizes, k_axis=2)
    if _on_cpu(dout, rhs):
        gmm_dlhs.plain_calls += 1
        return gmm_plain(dout, rhs.transpose(1, 2), group_sizes)
    out = _launch("gmm_dlhs", dout, rhs, group_sizes, rhs_t=True)
    gmm_dlhs.launches += 1
    return out


def tgmm(lhs, dout, group_sizes):
    """drhs of gmm: [G, K, N], group g's ``lhs[rows].T @ dout[rows]`` in
    lhs's dtype with f32 accumulation; an empty group's slab zero, rows
    past the last group adding nothing."""
    _check_tgmm(lhs, dout, group_sizes)
    if _on_cpu(lhs, dout):
        tgmm.plain_calls += 1
        return tgmm_plain(lhs, dout, group_sizes)
    out = _launch_tgmm(lhs, dout, group_sizes)
    tgmm.launches += 1
    return out


class _Gmm(torch.autograd.Function):
    """The JAX custom VJP of ``pallas_gmm.gmm``: the forward kernel, and
    a backward of dlhs (`gmm_dlhs`) and drhs (`tgmm`), each cast to its
    input's dtype."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        if _on_cpu(lhs, rhs):
            gmm.plain_calls += 1
            return gmm_plain(lhs, rhs, group_sizes)
        out = _launch("gmm", lhs, rhs, group_sizes, rhs_t=False)
        gmm.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.to(lhs.dtype).contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm_dlhs(dout, rhs, group_sizes).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, dout, group_sizes).to(rhs.dtype)
        return dlhs, drhs, None


def gmm(lhs, rhs, group_sizes):
    """Grouped matmul: row m of lhs [M, K] times rhs[g(m)] [K, N], in
    lhs's dtype with f32 accumulation; rows past the last group zero;
    differentiable in lhs and rhs (see the module docstring)."""
    _check("gmm", lhs, rhs, group_sizes)
    if _build.faked(lhs, rhs, group_sizes):
        # the plain version reads the sizes on the host, which a fake
        # tensor has not: graph capture gets the output's shape, dtype
        # and gradient flag from one product
        return (lhs @ rhs[0]).to(lhs.dtype)
    return _Gmm.apply(lhs, rhs, group_sizes)


for _fn in (gmm, gmm_dlhs, tgmm):
    _fn.launches = 0
    _fn.plain_calls = 0


register_oracle(
    "gmm", kernel=gmm, reference=gmm_plain, backward=(gmm_dlhs, tgmm),
    parity_test="tests/test_torch_moe.py::TestGmmParity",
    backward_parity_test="tests/test_torch_moe_train.py::TestGmmBackward")
