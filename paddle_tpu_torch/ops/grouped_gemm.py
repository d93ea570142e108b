"""Grouped GEMM of the MoE experts and the sort that groups their rows
(counterpart of paddle_tpu/ops/grouped_gemm.py).

``grouped_gemm`` is ``ops.gmm.gmm``: the kernel on CUDA tensors, its
plain version on CPU tensors. The JAX package chooses among several
routes by ``FLAGS_gmm_impl``; the port has this one, which the flag's
"auto" and "intree" name (its other values are refused when set).
Nothing falls back: a shape the kernel refuses raises on the card.

``sort_by_group`` is a stable ``argsort`` of the group ids, its inverse
a second stable ``argsort``, and the sizes a scatter-add of ones; all
run on the tensors' device with static shapes and read nothing back to
the host (``torch.bincount`` would: it reads the largest id to size its
output).
"""

from __future__ import annotations

import torch

from .gmm import gmm

__all__ = ["grouped_gemm", "sort_by_group", "unsort_by_group"]


def grouped_gemm(lhs, rhs, group_sizes):
    """lhs [M, K] rows grouped contiguously; rhs [G, K, N]; group_sizes
    [G] (sum <= M). Returns [M, N] in lhs's dtype, row m multiplied by
    its group's rhs (rows past the last group zero)."""
    return gmm(lhs, rhs, group_sizes)


def sort_by_group(x, group_ids, num_groups: int):
    """Stable-sort the rows of x by group id. Returns (sorted rows,
    group sizes int32 [num_groups], inverse permutation)."""
    order = torch.argsort(group_ids, stable=True)
    inv = torch.argsort(order, stable=True)
    sizes = torch.zeros(num_groups, dtype=torch.int32,
                        device=group_ids.device).scatter_add_(
        0, group_ids, torch.ones_like(group_ids, dtype=torch.int32))
    return x[order], sizes, inv


def unsort_by_group(x_sorted, inverse_perm):
    return x_sorted[inverse_perm]
