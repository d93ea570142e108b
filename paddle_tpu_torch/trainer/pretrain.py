"""Llama pretraining step on one device (counterpart of
paddle_tpu/trainer/pretrain.py).

The JAX step is one jitted SPMD program over a mesh; the port runs the
same arithmetic eagerly on one card: bf16 compute weights cast from f32
master weights (``amp.decorate_tree`` semantics), the model's own forward
(``LlamaModel.forward``: the decoder layers in a Python loop in place of
``stage_fn``'s scan, with the `remat` policy, attention through the flash
kernel, the final norm), a chunked cross-entropy, gradient accumulation
over microbatches, and the framework's AdamW
(``optimizer.FunctionalAdamW``) with global-norm clipping. Multi-device layouts (dp, mp, pp, sharding, sep, vpp and the
pipeline timetables) are ROADMAP.md queue A item 8 and raise.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..amp import decorate_tree
from ..device import DeviceLike, resolve_device
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..optimizer.functional import FunctionalAdamW

__all__ = ["PretrainConfig", "TrainState", "build_llama_pretrain_step",
           "flops_per_token", "flops_per_token_hw"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_MULTI_DEVICE = ("multi-device training is not ported yet (ROADMAP.md "
                 "queue A item 8)")


class PretrainConfig:
    """The JAX package's PretrainConfig, with its checks. On one device
    `scan_layers` has no effect (eager PyTorch runs the layers in a
    Python loop either way); `remat` is "full" (checkpoint each layer),
    "dots" (keep matrix-product outputs, recompute the rest) or "none";
    `ce_chunks` bounds the live logits at B * S / ce_chunks rows."""

    def __init__(self, model: LlamaConfig, global_batch=8, seq_len=512,
                 n_microbatches=1, lr=3e-4, weight_decay=0.1,
                 param_dtype="bfloat16", grad_clip=1.0,
                 dp=1, mp=1, pp=1, sharding=1, sep=1, vpp=1,
                 scan_layers: bool = True, remat: str = "full",
                 ce_chunks: int = 4, pp_schedule: str = "compiled",
                 moment_dtype: str = "float32"):
        self.model = model
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.n_microbatches = n_microbatches
        self.lr = lr
        self.weight_decay = weight_decay
        self.param_dtype = param_dtype
        self.grad_clip = grad_clip
        self.dp, self.mp, self.pp = dp, mp, pp
        self.sharding, self.sep = sharding, sep
        self.vpp = vpp
        self.scan_layers = scan_layers
        if remat not in ("full", "dots", "none"):
            raise ValueError(f"remat must be full|dots|none, got {remat!r}")
        self.remat = remat
        if ce_chunks < 1:
            raise ValueError(f"ce_chunks must be >= 1, got {ce_chunks}")
        self.ce_chunks = ce_chunks
        if pp_schedule not in ("compiled", "1F1B", "ZBH1", "FThenB", "VPP"):
            raise ValueError(f"unknown pp_schedule {pp_schedule!r}")
        if pp_schedule == "VPP" and vpp <= 1:
            raise ValueError("pp_schedule='VPP' needs vpp>1 virtual "
                             "chunks per stage")
        if vpp > 1 and pp_schedule not in ("compiled", "VPP", "1F1B"):
            raise ValueError(f"pp_schedule={pp_schedule!r} does not "
                             f"support vpp>1 (use 'VPP' for the "
                             f"interleaved timetable executor)")
        if pp_schedule != "compiled" and pp <= 1:
            raise ValueError(f"pp_schedule={pp_schedule!r} requires "
                             f"pp>1 (got pp={pp}); a single stage has "
                             f"no pipeline to schedule")
        self.pp_schedule = pp_schedule
        if moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"moment_dtype must be float32|bfloat16, "
                             f"got {moment_dtype!r}")
        self.moment_dtype = moment_dtype
        if param_dtype not in _DTYPES:
            raise ValueError(f"param_dtype must be bfloat16|float32, got "
                             f"{param_dtype!r}")


def _n_params(c: LlamaConfig) -> float:
    return (c.vocab_size * c.hidden_size * (1 if c.tie_word_embeddings else 2)
            + c.num_hidden_layers * (
                c.hidden_size * c.head_dim
                * (c.num_attention_heads + 2 * c.num_key_value_heads)
                + c.num_attention_heads * c.head_dim * c.hidden_size
                + 3 * c.hidden_size * c.intermediate_size
                + 2 * c.hidden_size)
            + c.hidden_size)


def flops_per_token(c: LlamaConfig) -> float:
    """6 N FLOPs a token: weight FLOPs only, no attention term (the
    model-FLOPs MFU denominator)."""
    return 6.0 * _n_params(c)


def flops_per_token_hw(c: LlamaConfig, seq_len: int) -> float:
    """6 N plus the dense attention term 12 L H D S (forward and backward
    of q k^T and p v, causal masking not discounted): the hardware-FLOPs
    MFU denominator."""
    attn = (12.0 * c.num_hidden_layers * c.num_attention_heads * c.head_dim
            * seq_len)
    return 6.0 * _n_params(c) + attn


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # compute weights (the model's)
    master: Dict[str, torch.Tensor]   # f32 master weights
    opt_state: Any                    # optimizer.AdamWState
    step: int


def _refuse_multi_device(cfg: PretrainConfig) -> None:
    for name in ("dp", "mp", "pp", "sharding", "sep", "vpp"):
        if getattr(cfg, name) > 1:
            raise NotImplementedError(f"{name}={getattr(cfg, name)}: "
                                      + _MULTI_DEVICE)
    if cfg.pp_schedule != "compiled":
        raise NotImplementedError(f"pp_schedule={cfg.pp_schedule!r}: "
                                  + _MULTI_DEVICE)


def _chunk_loss(h_c, labels_c, w_head):
    """Sum of token losses of one chunk: bf16 (compute dtype) logits
    cast to f32, logsumexp minus the picked logit."""
    logits = (h_c @ w_head).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    return (lse - picked).sum()


def build_llama_pretrain_step(cfg: PretrainConfig, device: DeviceLike = None,
                              model: Optional[LlamaForCausalLM] = None):
    """Returns (state, train_step, meta).

    ``train_step(state, ids, labels)`` takes int [global_batch, seq_len]
    ids and labels and returns ``(state, {"loss", "grad_norm"})``, both
    0-dim f32 tensors on the device (the loss is the token-loss sum over
    global_batch * seq_len; grad_norm the norm before clipping).

    `model` (a LlamaForCausalLM) supplies the initial weights; without
    one, a model of ``cfg.model`` is drawn on `device` (None: the card)
    from the default seeded generator. The step takes the model over:
    its parameters become the compute weights, in ``cfg.param_dtype``,
    and the f32 master weights, the moments and the gradients are
    updated in place (with ``param_dtype="float32"`` compute and master
    weights are the same tensors)."""
    _refuse_multi_device(cfg)
    mc = cfg.model
    B, S, M = cfg.global_batch, cfg.seq_len, cfg.n_microbatches
    if B % M:
        raise ValueError(f"global_batch {B} does not split into "
                         f"{M} microbatches")
    if S > mc.max_position_embeddings:
        raise ValueError(f"seq_len {S} exceeds the model's rope tables "
                         f"(max_position_embeddings "
                         f"{mc.max_position_embeddings})")
    if model is None:
        dev = resolve_device(device)
        model = LlamaForCausalLM(mc, device=dev, dtype=torch.float32)
    else:
        dev = next(model.parameters()).device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"model parameters live on {dev}, not on "
                             f"{resolve_device(device)}")
    dt = _DTYPES[cfg.param_dtype]
    named = dict(model.named_parameters())
    master = {k: p.data.float() for k, p in named.items()}
    compute = decorate_tree(master, dt)   # the same tensors when dt is f32
    for k, p in named.items():
        p.data = compute[k]
    params = named
    tx = FunctionalAdamW(cfg.lr, beta1=0.9, beta2=0.95, epsilon=1e-8,
                         weight_decay=cfg.weight_decay,
                         clip_norm=cfg.grad_clip,
                         moment_dtype=cfg.moment_dtype)
    state = TrainState(params, master, tx.init(master), 0)

    inner = model.llama
    w_head_of = (lambda: model.lm_head.weight) if model.lm_head is not None \
        else (lambda: inner.embed_tokens.weight.T)

    def loss_fn(ids, labels):
        """Token-loss sum of a microbatch over B * S."""
        hn = inner(ids, remat=cfg.remat)    # final norm in F.rms_norm order
        w_head = w_head_of()
        n = min(cfg.ce_chunks, S)
        bounds = [i * S // n for i in range(n)] + [S]
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            # recomputed in the backward: one chunk's logits live at a time
            total = total + checkpoint(_chunk_loss, hn[:, lo:hi],
                                       labels[:, lo:hi], w_head,
                                       use_reentrant=False)
        return total / (B * S)

    def train_step(state: TrainState, ids, labels):
        ids = torch.as_tensor(ids, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        if tuple(ids.shape) != (B, S) or labels.shape != ids.shape:
            raise ValueError(f"ids/labels {tuple(ids.shape)} / "
                             f"{tuple(labels.shape)}; the config takes "
                             f"[{B}, {S}]")
        for p in state.params.values():
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        mb = B // M
        for i in range(M):
            part = loss_fn(ids[i * mb:(i + 1) * mb],
                           labels[i * mb:(i + 1) * mb])
            part.backward()
            loss = loss + part.detach()
        grads = {}
        for k, p in state.params.items():
            grads[k] = p.grad.float()   # the cast's VJP: f32 master grads
            p.grad = None
        master, opt_state, gnorm = tx.update(grads, state.opt_state,
                                             state.master)
        with torch.no_grad():
            for k, p in state.params.items():
                if p.data_ptr() != master[k].data_ptr():
                    p.copy_(master[k])
        return (TrainState(state.params, master, opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    meta = {"model": model, "device": dev,
            "flops_per_token": flops_per_token(mc)}
    return state, train_step, meta
