"""Gradient clipping of the eager optimizers (counterpart of
paddle_tpu/nn/clip.py: ``ClipGradByGlobalNorm``, the clip the LLM
recipes use, and ``clip_grad_norm_``).

A clip takes the optimizer's ``[(param, grad), ...]`` and returns the
pairs with each grad scaled. Where the JAX package rebinds new arrays,
the port scales every gradient IN PLACE (``param.grad`` too) and
returns the same tensors: a second copy of a 3B-parameter model's
gradients would not sit beside the first on the card. A parameter
carrying ``need_clip = False`` (Paddle's ``ParamAttr(need_clip=False)``)
is left out of both the norm and the scaling.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["ClipGradByGlobalNorm", "clip_grad_norm_"]


def _scale_(g, scale) -> None:
    """g <- g * scale in f32, cast back to g's dtype."""
    g.copy_(g.float() * scale)


class ClipGradByGlobalNorm:
    """Scale every clippable gradient by ``clip_norm / max(norm,
    clip_norm)``, the norm the f32 root of the sum of squares over them.
    ``last_norm`` keeps the norm of the last call (before clipping)."""

    def __init__(self, clip_norm: float = 1.0,
                 group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = float(clip_norm)
        self.last_norm: Optional[torch.Tensor] = None

    def __call__(self, params_grads: List[Tuple[torch.Tensor,
                                                Optional[torch.Tensor]]]):
        live = [g for p, g in params_grads
                if g is not None and getattr(p, "need_clip", True)]
        if not live:
            return params_grads
        sq = None
        for g in live:
            s = g.float().square().sum()
            sq = s if sq is None else sq + s
        norm = torch.sqrt(sq)
        self.last_norm = norm
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        with torch.no_grad():
            for g in live:
                _scale_(g, scale)
        return params_grads


def clip_grad_norm_(parameters, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False):
    """Scale the grads of `parameters` in place so that their total
    `norm_type` norm is at most `max_norm` (scale ``min(max_norm /
    max(total, 1e-6), 1)``); returns the total norm before clipping (f32
    sums of ``|g| ** norm_type``; the largest ``|g|`` for inf)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    with torch.no_grad():
        if norm_type == float("inf"):
            total = torch.stack([p.grad.abs().max().float()
                                 for p in params]).max()
        else:
            total = torch.stack(
                [(p.grad.float().abs() ** norm_type).sum() for p in params]
            ).sum() ** (1.0 / norm_type)
        if error_if_nonfinite and not bool(torch.isfinite(total)):
            raise RuntimeError(f"clip_grad_norm_: the total norm is "
                               f"{float(total)}")
        scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6),
                            max=1.0)
        for p in params:
            _scale_(p.grad, scale)
    return total
