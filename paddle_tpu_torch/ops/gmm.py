"""The grouped GEMM of the MoE experts, forward (counterpart of
paddle_tpu/ops/pallas_gmm.py).

Contract, the JAX kernel's: ``lhs`` [M, K] with rows grouped
contiguously, ``rhs`` [G, K, N], ``group_sizes`` [G] integer with sum
<= M; ``out[m] = lhs[m] @ rhs[g(m)]`` in lhs's dtype, accumulated in
f32; rows past the last group come out zero.

``gmm`` launches the hand-written CUDA kernel of ``csrc/gmm.cu`` on CUDA
tensors and runs its plain PyTorch version ``gmm_plain`` on CPU tensors.
A CUDA tensor launches the kernel or raises; nothing falls back. On the
card the wrapper reads nothing back to the host: the group ends are a
``cumsum`` on the card and the grid is fixed by rhs's shape, so a
serving step does not wait on its routing. The wrapper counts
``.launches`` and ``.plain_calls``.

The backward (the JAX custom VJP's dlhs, the same kernel against rhs
transposed, and ``tgmm``'s drhs) belongs to MoE training, not ported
yet: on the card an input that requires a gradient raises. On the CPU
the plain version is differentiable by autograd.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .oracles import register_oracle

__all__ = ["gmm", "gmm_plain", "gmm_kernel_eligible"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def gmm_kernel_eligible(K: int, N: int, dtype: torch.dtype) -> bool:
    """The kernel copies lhs and weight rows in 16-byte pieces: K and N
    multiples of 8 in bf16, of 4 in f32 (Hopper's gate; the TPU kernel's
    K and N multiples of 128 do not apply)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return K % vec == 0 and N % vec == 0


def _check(lhs, rhs, group_sizes) -> None:
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(
            f"gmm: lhs [M, K], rhs [G, K, N], group_sizes [G]; got "
            f"{tuple(lhs.shape)}, {tuple(rhs.shape)}, "
            f"{tuple(group_sizes.shape)}")
    if rhs.shape[1] != lhs.shape[1] or group_sizes.shape[0] != rhs.shape[0]:
        raise ValueError(
            f"gmm: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} and "
            f"group_sizes {tuple(group_sizes.shape)} do not agree")
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"gmm: lhs {lhs.dtype} against rhs {rhs.dtype}")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gmm: group_sizes are int32/int64, got "
                        f"{group_sizes.dtype}")


def gmm_plain(lhs, rhs, group_sizes):
    """Plain version (the JAX package's ``gmm_reference``, group by
    group): each group's rows times its weight in f32, one cast to lhs's
    dtype; rows past the last group zero. Reads the sizes on the host."""
    _check(lhs, rhs, group_sizes)
    M = lhs.shape[0]
    out = torch.zeros(M, rhs.shape[2], dtype=lhs.dtype, device=lhs.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        end = min(start + max(int(n), 0), M)
        if end > start:
            out[start:end] = (lhs[start:end].float()
                              @ rhs[g].float()).to(lhs.dtype)
        start = end
    return out


def _launch(lhs, rhs, group_sizes):
    name = "gmm"
    dev = _build.require_cuda(name, lhs, rhs)
    M, K = lhs.shape
    G, _, N = rhs.shape
    if not gmm_kernel_eligible(K, N, lhs.dtype):
        raise ValueError(
            f"gmm: the kernel copies rows in 16-byte pieces: K and N must "
            f"be multiples of {16 // lhs.element_size()} for {lhs.dtype}, "
            f"got K={K}, N={N}")
    ends = torch.cumsum(_build.index32(name, group_sizes, dev), 0,
                        dtype=torch.int32)
    out = torch.empty(M, N, dtype=lhs.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    if G == 0:
        return out.zero_()
    _build.require_aligned(name, lhs, rhs, out)
    fn = _build.kernel("ptt_gmm", [_P] * 4 + [_I] * 6 + [_P])
    err = fn(lhs.data_ptr(), rhs.data_ptr(), ends.data_ptr(),
             out.data_ptr(), M, K, N, G, _build.dtype_code(lhs),
             dev.index or 0, _build.stream(lhs))
    _build.check(name, err)
    return out


def gmm(lhs, rhs, group_sizes):
    """Grouped matmul: row m of lhs [M, K] times rhs[g(m)] [K, N], in
    lhs's dtype with f32 accumulation; rows past the last group zero
    (see the module docstring)."""
    if lhs.device.type == "cpu" and rhs.device.type == "cpu":
        gmm.plain_calls += 1
        return gmm_plain(lhs, rhs, group_sizes)
    _check(lhs, rhs, group_sizes)
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        raise NotImplementedError(
            "gmm's backward (dlhs and tgmm) is the MoE training step of "
            "ROADMAP.md queue A item 5b, not ported yet: call gmm on the "
            "card without gradients (torch.no_grad())")
    out = _launch(lhs, rhs, group_sizes)
    gmm.launches += 1
    return out


gmm.launches = 0
gmm.plain_calls = 0


register_oracle(
    "gmm", kernel=gmm, reference=gmm_plain,
    parity_test="tests/test_torch_moe.py::TestGmmParity")
