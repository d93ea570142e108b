"""Functional AdamW (counterpart of paddle_tpu/optimizer/functional.py).

Plain tensor math over dicts of tensors keyed by parameter name; no
kernel of the JAX package sits behind it. Where the JAX package returns
new arrays (and donates the old ones to the step), the port updates the
master weights, the moments and the gradients IN PLACE and returns the
same tensors: at Llama-3-8B width a second copy of the f32 state would
not fit beside the first.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

__all__ = ["adamw_kernel", "global_norm", "clip_tree_by_global_norm",
           "AdamWState", "FunctionalAdamW"]

Tree = Dict[str, torch.Tensor]


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def adamw_kernel(w, g, m, v, t, *, lr, b1, b2, eps, weight_decay,
                 do_decay=True, vmax=None):
    """One decoupled-weight-decay Adam update of `w`, `m` and `v` in
    place, in f32 master precision and in the JAX kernel's op order. `t`
    is the 1-based step after this update; the scalars (lr, the bias
    corrections) are f32, as in the JAX kernel. Returns (w, m, v), and
    with `vmax` (amsgrad: the denominator takes the running max of vhat,
    kept in `vmax` in place) (w, m, v, vmax)."""
    g = g.to(w.dtype)
    lr = _f32(float(lr))    # 0-dim CPU scalars join CUDA ops as scalars
    if do_decay:
        w.mul_(1.0 - lr * weight_decay)
    m.mul_(b1).add_(g * (1.0 - b1))
    v.mul_(b2).add_(g.square().mul_(1.0 - b2))
    tf = _f32(float(t))
    bc1 = 1.0 - _f32(b1) ** tf
    bc2 = 1.0 - _f32(b2) ** tf
    mhat = m / bc1
    vhat = v / bc2
    if vmax is not None:
        vmax.copy_(torch.maximum(vmax, vhat))
        vhat = vmax.clone()
    w.sub_(mhat.mul_(lr).div_(vhat.sqrt_().add_(eps)))
    return (w, m, v) if vmax is None else (w, m, v, vmax)


def global_norm(grads: Tree) -> torch.Tensor:
    """f32 global l2 norm over a dict of gradients."""
    total = None
    for g in grads.values():
        if g is None:
            continue
        g32 = g.float()
        sq = (g32 * g32).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_tree_by_global_norm(grads: Tree, clip_norm: float):
    """ClipGradByGlobalNorm: every gradient scaled by
    clip_norm / max(norm, clip_norm), in place. Returns (grads, norm),
    the norm taken before clipping."""
    norm = global_norm(grads)
    scale = clip_norm / torch.clamp(norm, min=clip_norm)
    for k, g in grads.items():
        g.copy_(g.float() * scale)
    return grads, norm


class AdamWState(NamedTuple):
    moment1: Tree
    moment2: Tree
    count: int  # updates applied


class FunctionalAdamW:
    """AdamW over dicts of f32 master weights, with global-norm clipping,
    an optional decay mask (name -> bool; None decays everything) and
    moments stored in f32 or bf16 (the update math stays f32; bf16
    moments round on store). `learning_rate` is a float or a function of
    the 1-based step."""

    def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.01,
                 clip_norm: Optional[float] = None,
                 decay_mask: Optional[Dict[str, bool]] = None,
                 moment_dtype: Union[str, torch.dtype] = torch.float32):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.decay_mask = decay_mask
        if isinstance(moment_dtype, str):
            moment_dtype = {"float32": torch.float32,
                            "bfloat16": torch.bfloat16}[moment_dtype]
        self.moment_dtype = moment_dtype
        if moment_dtype != torch.float32 and beta2 > 0.99:
            # a bf16 second moment cannot take a (1 - b2) < 1% EMA step:
            # it rounds back to its old value and freezes
            raise ValueError(
                f"moment_dtype={moment_dtype} with beta2={beta2}: the "
                f"second-moment EMA stalls under bf16 rounding when "
                f"beta2 > 0.99; lower beta2 or keep float32 moments")

    def init(self, params: Tree) -> AdamWState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=self.moment_dtype)
                    for k, p in params.items()}
        return AdamWState(moment1=zeros(), moment2=zeros(), count=0)

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else self.lr

    def update(self, grads: Tree, state: AdamWState, params: Tree):
        """-> (params, state, grad_norm), params, moments and grads
        updated in place (the grads clipped). `params` are the f32
        master weights; the caller owns the compute cast."""
        if self.clip_norm is not None:
            grads, norm = clip_tree_by_global_norm(grads, self.clip_norm)
        else:
            norm = global_norm(grads)
        count = state.count + 1
        lr = self.lr_at(count)
        low = self.moment_dtype != torch.float32
        for k, w in params.items():
            m, v = state.moment1[k], state.moment2[k]
            m_in, v_in = (m.float(), v.float()) if low else (m, v)
            decay = True if self.decay_mask is None else \
                bool(self.decay_mask[k])
            adamw_kernel(w, grads[k], m_in, v_in, count, lr=lr, b1=self.b1,
                         b2=self.b2, eps=self.eps,
                         weight_decay=self.weight_decay, do_decay=decay)
            if low:
                m.copy_(m_in)
                v.copy_(v_in)
        return params, AdamWState(state.moment1, state.moment2, count), norm
