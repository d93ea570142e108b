"""Activation recompute (counterpart of paddle_tpu/distributed/recompute.py,
where ``jax.checkpoint`` is the mechanism): ``torch.utils.checkpoint``.
The region's activations are not kept; the backward runs its forward
again."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["recompute", "dots_saveable"]

#: the matrix products whose outputs `dots_saveable` keeps
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def dots_saveable():
    """Selective-checkpoint contexts that keep every matrix product's
    output and recompute the rest (``jax.checkpoint_policies.
    dots_saveable``); pass as ``policy`` to `recompute`."""
    return create_selective_checkpoint_contexts(_save_dots)


def recompute(function: Callable, *args, use_reentrant: bool = True,
              policy: Optional[Callable] = None, **kwargs):
    """``function(*args, **kwargs)`` under activation checkpointing.
    `policy` is a ``context_fn`` such as `dots_saveable` (None: recompute
    everything). `use_reentrant` is accepted for Paddle's signature; the
    port always takes PyTorch's non-reentrant checkpoint, which needs no
    input that requires grad and supports selective policies."""
    extra = {} if policy is None else {"context_fn": policy}
    return checkpoint(function, *args, use_reentrant=False, **extra,
                      **kwargs)
