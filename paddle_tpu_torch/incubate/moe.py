"""Mixture-of-Experts FFN (counterpart of paddle_tpu/incubate/moe.py).

The routed experts are stacked weights ``w_gate`` / ``w_up`` [E, H, I]
and ``w_down`` [E, I, H] beside the router ``gate_weight`` [H, E] and an
optional shared expert (``shared_gate`` / ``shared_up`` / ``shared_down``
Linears, [in, out]): the JAX package's parameter names and layouts, so
state dicts carry over key for key.

Numerics follow the JAX package: the router runs in f32 (``x.float() @
gate.float()``, softmax); top-k is in rank order (descending, ties to
the lower expert id, as ``lax.top_k``); each expert product comes back
in the activation dtype, ``silu(g) * up`` runs in that dtype, and the
combine multiplies the k selected outputs by their gates cast to that
dtype and reduces over k in rank order.

- ``top_k_gating``: the GShard capacity planner (dispatch / combine
  tensors, choice-major capacity, the first-choice aux loss) over
  ``gating_plan``'s operands;
- ``dense_expert_ffn``: every expert on every token, then the weighted
  select (the serving path at T <= 32); plain batched ``torch.matmul``
  over the experts, a large product the JAX package leaves to XLA;
- ``dropless_expert_ffn``: (token, choice) rows sorted by expert, three
  grouped GEMMs (``ops.gmm``: the hand-written kernels on the card,
  forward and backward), unsorted, combined; nothing is read back to
  the host;
- ``MoELayer``: the capacity forward and the dropless forward, the aux
  loss in ``l_aux``; both train: the dropless route's gradients run
  through gmm's backward kernels (dlhs, tgmm), the capacity route's
  through ``torch.einsum`` (the JAX package leaves it to XLA), and the
  router's ``gate_weight`` takes gradients through the renormalised
  top-k gates and through ``l_aux``;
- ``SwitchMoELayer`` (top-1, gelu experts) and
  ``ClipGradForMOEByGlobalNorm`` (a global-norm clip over every
  parameter: on one device the expert weights are whole).

``global_scatter`` / ``global_gather`` (expert parallelism) are not
ported yet (ROADMAP.md queue A item 8).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..device import DeviceLike, resolve_device
from ..nn import Linear
from ..nn.clip import clip_grad_norm_
from ..nn.functional import gelu
from ..ops.gmm import gmm
from ..ops.grouped_gemm import sort_by_group, unsort_by_group

__all__ = ["top_k_gating", "gating_plan", "load_balance_loss",
           "router_z_loss", "dense_expert_ffn", "dropless_expert_ffn", "MoELayer",
           "SwitchMoELayer", "ClipGradForMOEByGlobalNorm"]


def _top_k(gates, k: int):
    """(values, indices) of the k largest gates of each row in
    ``lax.top_k``'s order: descending, equal values by the lower index
    (a stable sort; ``torch.topk`` fixes no order among ties)."""
    v, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _one_hot(idx, n: int, dtype):
    """``F.one_hot(idx, n).to(dtype)`` as a scatter: F.one_hot checks its
    indices' range on the host, a read-back that would stall every
    training step on its routing."""
    out = torch.zeros(*idx.shape, n, dtype=dtype, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


def _renorm(gv, renormalize: bool):
    if renormalize:
        gv = gv / torch.clamp_min(gv.sum(-1, keepdim=True), 1e-9)
    return gv


def _act(g, up, activation: str):
    """The expert activation in the products' dtype: silu(g) * up, or
    jax.nn.gelu's tanh form of up."""
    if activation == "swiglu":
        return F.silu(g) * up
    return gelu(up, approximate=True)


def gating_plan(gates, k: int, capacity: int, *, renormalize: bool = True):
    """The GShard planner's operands: (keep [T, k, E] 0/1, the slot
    one-hots oh_loc [T, k, C], the gates gv [T, k], the aux loss).
    Priority is choice-major: every first choice claims capacity before
    any second choice."""
    T, E = gates.shape
    topv, topi = _top_k(gates, k)                            # [T, k]
    mask = _one_hot(topi, E, gates.dtype)                    # [T, k, E]
    # position of each (token, choice) in its expert's queue, choice-major
    mask_km = mask.transpose(0, 1).reshape(k * T, E)
    pos_km = torch.cumsum(mask_km, 0) - mask_km
    pos = pos_km.reshape(k, T, E).transpose(0, 1)            # [T, k, E]
    keep = mask * (pos < capacity)
    loc = (pos * keep).sum(-1).long()                        # [T, k]
    kept_any = keep.sum(-1)                                  # [T, k] 0/1
    # aux load-balance loss on first choices (GShard eq. 13)
    aux = E * (gates.mean(0) * mask[:, 0, :].mean(0)).sum()
    gv = _renorm(topv * kept_any, renormalize)
    oh_loc = _one_hot(loc, capacity, gates.dtype) * kept_any[..., None]
    return keep, oh_loc, gv, aux


def top_k_gating(gates, k: int, capacity: int, *, renormalize: bool = True):
    """GShard-style top-k dispatch planner. gates [T, E] softmax router
    probabilities -> (dispatch [T, E, C] 0/1, combine [T, E, C], aux
    loss), the einsum pair over `gating_plan`'s operands (the pair the
    fusion pass's moe_dispatch rewrite fuses)."""
    keep, oh_loc, gv, aux = gating_plan(gates, k, capacity,
                                        renormalize=renormalize)
    dispatch = torch.einsum("tke,tkc->tec", keep, oh_loc)
    combine = torch.einsum("tk,tke,tkc->tec", gv, keep, oh_loc)
    return dispatch, combine, aux


def load_balance_loss(gates, expert_mask):
    """Switch-Transformer aux loss: E * sum_e mean(prob_e) * mean(frac_e)."""
    E = gates.shape[-1]
    return E * (gates.mean(0) * expert_mask.mean(0)).sum()


def router_z_loss(logits):
    """ST-MoE z-loss: mean(logsumexp(logits)^2)."""
    return (torch.logsumexp(logits, -1) ** 2).mean()


def dense_expert_ffn(xt, gates, wg, wu, wd, *, top_k: int,
                     renormalize: bool, activation: str = "swiglu"):
    """Decode-sized routed FFN: every expert on every token, then the k
    selected outputs of each token weighted and reduced in rank order,
    exactly as the grouped path combines. Returns (y [T, H], topi
    [T, k]). The products are the JAX body's einsums "th,ehi->eti" and
    "eti,eih->eth" as batched matmuls over the experts: torch.einsum
    would treat the expert axis of "ehi" as an output axis of the weight
    alone and copy the whole stack into another layout first."""
    topv, topi = _top_k(gates, top_k)
    gv = _renorm(topv, renormalize)
    up = torch.matmul(xt, wu)                              # [E, T, I]
    g = torch.matmul(xt, wg) if activation == "swiglu" else None
    down = torch.matmul(_act(g, up, activation), wd)       # [E, T, H]
    T = xt.shape[0]
    sel = down[topi, torch.arange(T, device=xt.device)[:, None]]  # [T, k, H]
    y = torch.einsum("tk,tkh->th", gv.to(sel.dtype), sel)
    return y, topi


def dropless_expert_ffn(xt, gates, wg, wu, wd, *, top_k: int,
                        renormalize: bool, activation: str = "swiglu"):
    """Per-token top-k routed expert FFN, dropless: the (token, choice)
    rows sorted by expert, one grouped GEMM (``gmm``) per expert weight,
    unsorted, weighted and reduced over k in rank order. The single source of the routing
    numerics for MoELayer's dropless forward and the serving path.
    Returns (y [T, H], topi [T, k])."""
    E = wu.shape[0]
    T, H = xt.shape
    topv, topi = _top_k(gates, top_k)
    gv = _renorm(topv, renormalize)
    rows = xt[:, None, :].expand(T, top_k, H).reshape(T * top_k, H)
    srt, sizes, inv = sort_by_group(rows, topi.reshape(-1), E)
    up = gmm(srt, wu, sizes)
    g = gmm(srt, wg, sizes) if activation == "swiglu" else None
    down = gmm(_act(g, up, activation), wd, sizes)
    down = unsort_by_group(down, inv).reshape(T, top_k, -1)
    y = torch.einsum("tk,tkh->th", gv.to(down.dtype), down)
    return y, topi


class MoELayer(nn.Module):
    """Top-k routed MoE FFN (GShard / Qwen2-MoE pattern).

    Capacity mode (the default): GShard dispatch einsums, overflow tokens
    dropped. Dropless mode: `dropless_expert_ffn`. After forward,
    ``self.l_aux`` holds the aux loss (f32, differentiable). Parameters
    are drawn in ``dtype`` on ``device`` from ``generator``: the router
    from N(0, 0.02), the expert stacks from the JAX package's Xavier
    normal (fan_in H * I, fan_out E * I for [E, H, I]), the shared expert
    as Linear."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: str = "swiglu", dropless: bool = False,
                 renormalize: bool = True,
                 shared_expert_hidden: int = 0, z_loss_weight: float = 0.0,
                 *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in ("swiglu", "gelu"):
            raise ValueError(f"unsupported activation: {activation}")
        dev = resolve_device(device)
        self.d_model, self.d_hidden = d_model, d_hidden
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.dropless = dropless
        self.renormalize = renormalize
        self.z_loss_weight = z_loss_weight
        self.l_aux = None
        E, H, Iw = num_experts, d_model, d_hidden

        def draw(shape, std):
            return nn.Parameter(torch.empty(shape, device=dev, dtype=dtype)
                                .normal_(0.0, std, generator=generator))

        def xavier(shape):
            r = shape[2]
            return draw(shape, math.sqrt(2.0 / (shape[1] * r + shape[0] * r)))

        self.gate_weight = draw((H, E), 0.02)
        self.w_up = xavier((E, H, Iw))
        self.w_gate = xavier((E, H, Iw)) if activation == "swiglu" else None
        self.w_down = xavier((E, Iw, H))
        if shared_expert_hidden:
            kw = dict(device=dev, dtype=dtype, generator=generator)
            self.shared_up = Linear(H, shared_expert_hidden, bias_attr=False,
                                    **kw)
            self.shared_gate = Linear(H, shared_expert_hidden,
                                      bias_attr=False, **kw)
            self.shared_down = Linear(shared_expert_hidden, H,
                                      bias_attr=False, **kw)
        else:
            self.shared_up = None

    def _expert_ffn(self, disp):
        """The experts on dispatched tokens [E, C, H] -> [E, C, H]."""
        up = torch.einsum("ech,ehi->eci", disp, self.w_up)
        g = torch.einsum("ech,ehi->eci", disp, self.w_gate) \
            if self.activation == "swiglu" else None
        return torch.einsum("eci,eih->ech", _act(g, up, self.activation),
                            self.w_down)

    def _capacity(self, T: int) -> int:
        c = int(self.capacity_factor * self.top_k * T / self.num_experts)
        return max(c, self.top_k)

    def forward(self, x):
        shape = x.shape
        T = math.prod(shape[:-1])
        xt = x.reshape(T, shape[-1])
        logits = xt.float() @ self.gate_weight.float()        # f32 router
        gates = torch.softmax(logits, -1)
        if self.dropless:
            y, topi = dropless_expert_ffn(
                xt, gates, self.w_gate, self.w_up, self.w_down,
                top_k=self.top_k, renormalize=self.renormalize,
                activation=self.activation)
            mask1 = _one_hot(topi[:, 0], self.num_experts, gates.dtype)
            aux = load_balance_loss(gates, mask1)
        else:
            dispatch, combine, aux = top_k_gating(
                gates, self.top_k, self._capacity(T),
                renormalize=self.renormalize)
            disp = torch.einsum("tec,th->ech", dispatch.to(x.dtype), xt)
            y = torch.einsum("tec,ech->th", combine.to(x.dtype),
                             self._expert_ffn(disp))
        if self.z_loss_weight:
            aux = aux + self.z_loss_weight * router_z_loss(logits)
        self.l_aux = aux.float()
        out = y.reshape(shape).to(x.dtype)
        if self.shared_up is not None:
            s = F.silu(self.shared_gate(x)) * self.shared_up(x)
            out = out + self.shared_down(s)
        return out


class SwitchMoELayer(MoELayer):
    """Switch Transformer: top-1 routing, capacity_factor ~1.0-2.0, gelu
    experts unless `activation` says otherwise."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 capacity_factor: float = 2.0, **kw):
        kw.setdefault("activation", "gelu")
        super().__init__(d_model, d_hidden, num_experts, top_k=1,
                         capacity_factor=capacity_factor, **kw)


class ClipGradForMOEByGlobalNorm:
    """MoE-aware global-norm clip (ref: ClipGradForMOEByGlobalNorm): with
    expert parallelism each expert shard's gradients enter the norm once;
    on one device every expert weight is whole, so this is
    ``nn.clip_grad_norm_`` over all the parameters that have a gradient
    (scaled in place). `is_expert_param_fn` and `moe_group` are kept for
    the signature."""

    def __init__(self, clip_norm: float, is_expert_param_fn=None,
                 moe_group=None):
        self.clip_norm = float(clip_norm)
        self.is_expert_param_fn = is_expert_param_fn

    def __call__(self, params_grads):
        clip_grad_norm_([p for p, _ in params_grads], self.clip_norm)
        return params_grads
