"""Text generation and the decode weight tree (counterpart of
paddle_tpu/generation.py, Llama family).

Ported:

- `generate`: the buffer model. Every step runs the model's forward on a
  fixed [B, prompt + max_new_tokens] buffer and reads the logits at the
  current position (causal attention makes the pad tail irrelevant).
  The oracle `generate_cached` is held to.
- `generate_cached`: KV-cache decoding. One prefill over the prompt,
  whose attention goes through ``ops.flash_attention.sdpa_prefill`` (the
  flash kernel on the card, once a layer), then one token a step: the
  step's K/V rows are written into preallocated [B, total, KV, D] caches
  IN PLACE (the JAX body returned updated copies) and attention is the
  dense masked einsum over the cache, in the JAX body's op order.
- `_decode_params`, `_llama_decode_params` (fp layout), `_llama_weights`,
  `_mm_w` (fp branch), `_ffn_apply` (dense SwiGLU): the weight tree the
  serving engine reads too. The weight-only int8/int4 layouts raise
  naming ROADMAP.md queue A item 4; the gpt, MoE and MLA families raise
  naming item 5. `generate_compiled` and the beam searches are not
  ported yet (queue A item 3).

PyTorch idiom: an eager Python loop, no jit. Inputs move to the model's
device, so the model decides where the call runs (a model built with
``device=None`` lives on the card). Sampling takes an explicit
``generator`` (a ``torch.Generator`` on that device; None uses
PyTorch's default one): the JAX package's global ``next_key()`` has no
counterpart, and sampled tokens cannot match JAX's random bits, only
its distribution. Greedy decoding (``decode_strategy="greedy_search"``,
or a temperature <= 0) matches the JAX package token for token.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from . import resilience as _res

__all__ = ["generate", "generate_cached"]


# ---------------------------------------------------------------------------
# sampling and results
# ---------------------------------------------------------------------------
def _finalize_tokens(out_tokens, out_scores, B, max_new_tokens,
                     pad_token_id, device):
    """Stack + right-pad the per-step token/score lists to the full
    [B, max_new_tokens] width (early eos or deadline expiry leaves the
    lists short; an expiry before the first token leaves them empty)."""
    if out_tokens:
        gen = torch.stack(out_tokens, 1)
        sc = torch.stack(out_scores, 1)
    else:
        gen = torch.zeros((B, 0), dtype=torch.int32, device=device)
        sc = torch.zeros((B, 0), dtype=torch.float32, device=device)
    if gen.shape[1] < max_new_tokens:
        padw = max_new_tokens - gen.shape[1]
        gen = torch.cat([gen, torch.full((B, padw), pad_token_id,
                                         dtype=torch.int32, device=device)],
                        1)
        sc = torch.cat([sc, torch.zeros((B, padw), dtype=sc.dtype,
                                        device=device)], 1)
    return gen, sc


def _timeout_result(kind, dl, completed, partial):
    """Typed deadline-expiry return (resilience.TimeoutResult): counts
    the miss and carries whatever tokens were produced in time."""
    _res.deadline_miss()
    return _res.TimeoutResult(kind=kind, budget_s=dl.budget_s,
                              elapsed_s=dl.elapsed_s,
                              completed=completed, partial=partial)


def _logits_fn(model, ids):
    """One forward on the padded buffer -> [B, S, V] logits."""
    out = model(ids)
    if isinstance(out, tuple):
        out = out[-1]
    return out


def _sample_token(logits, strategy, top_k, top_p, temperature,
                  generator: Optional[torch.Generator] = None):
    """logits [B, V] -> token ids [B] int32."""
    if strategy == "greedy_search" or (temperature is not None
                                       and temperature <= 0.0):
        # temperature 0 degenerates to greedy (the usual convention),
        # never a silent fall-through to temperature-1 sampling
        return torch.argmax(logits, -1).to(torch.int32)
    probs = torch.softmax(
        _filter_logits(logits.float(), top_k, top_p, temperature), -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _filter_logits(logits, top_k, top_p, temperature):
    """Temperature, then top-k, then top-p (the smallest prefix of the
    sorted distribution with cumulative probability >= top_p); removed
    entries become -inf."""
    if temperature is not None and temperature != 1.0:
        logits = logits / temperature
    if top_k:
        kth = torch.sort(logits, -1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, -float("inf")), logits)
    if top_p and top_p < 1.0:
        sorted_logits = torch.sort(logits, -1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, -1), -1)
        cutoff_idx = (cum < top_p).sum(-1).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, -float("inf")), logits)
    return logits


def _score(logits, tok):
    """The chosen tokens' log-probabilities, in f32."""
    logp = torch.log_softmax(logits.float(), -1)
    return torch.gather(logp, -1, tok.long()[:, None])[:, 0]


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _as_ids(input_ids, device) -> torch.Tensor:
    """Token ids (numpy, list or tensor) as [B, S] int64 on `device`."""
    if not isinstance(input_ids, torch.Tensor):
        input_ids = torch.as_tensor(np.asarray(input_ids))
    return input_ids.to(device=device, dtype=torch.long)


def _check_strategy(decode_strategy: str) -> None:
    if decode_strategy not in ("greedy_search", "sampling"):
        raise ValueError(f"decode_strategy {decode_strategy!r}: expected "
                         "'greedy_search' or 'sampling'")


def generate(model, input_ids, max_new_tokens: int = 20,
             decode_strategy: str = "sampling", top_k: Optional[int] = None,
             top_p: Optional[float] = None, temperature: float = 1.0,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             deadline_s: Optional[float] = None,
             generator: Optional[torch.Generator] = None):
    """PaddleNLP's model.generate(...). Returns (generated_ids, scores)
    on the model's device: generated_ids [B, max_new_tokens] int32 holds
    ONLY the new tokens, padded with pad_token_id after eos; scores
    [B, max_new_tokens] f32 are the chosen tokens' log-probs.

    ``deadline_s`` bounds the request wall-clock: the decode loop stops
    at the first step past the budget and the call returns a falsy
    resilience.TimeoutResult whose .partial carries the (padded) tokens
    produced in time."""
    _check_strategy(decode_strategy)
    dev = _model_device(model)
    ids = _as_ids(input_ids, dev)
    B, S0 = ids.shape
    total = S0 + max_new_tokens
    # the tail is never attended before it is written (causal), and a
    # finished row's logits are discarded: the buffer holds the sampled
    # ids and 0 past them, so every id it feeds stays in the vocabulary
    # (a negative pad_token_id is valid in the output only)
    buf = torch.cat([ids, torch.zeros((B, max_new_tokens), dtype=torch.long,
                                      device=dev)], 1)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    out_tokens, out_scores = [], []
    dl = _res.Deadline(deadline_s) if deadline_s else None
    timed_out = False
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for t in range(S0 - 1, total - 1):
                if dl is not None and dl.expired():
                    timed_out = True
                    break
                logits = _logits_fn(model, buf)[:, t]
                tok = _sample_token(logits, decode_strategy, top_k, top_p,
                                    temperature, generator)
                score = _score(logits, tok)
                buf[:, t + 1] = tok
                if eos_token_id is not None:
                    tok = torch.where(finished,
                                      torch.full_like(tok, pad_token_id), tok)
                    score = torch.where(finished, torch.zeros_like(score),
                                        score)
                    finished = finished | (tok == eos_token_id)
                out_tokens.append(tok)
                out_scores.append(score)
                if eos_token_id is not None and bool(finished.all()):
                    break
    finally:
        if was_training:
            model.train()
    partial = _finalize_tokens(out_tokens, out_scores, B, max_new_tokens,
                               pad_token_id, dev)
    if timed_out:
        return _timeout_result("generate", dl, len(out_tokens), partial)
    return partial


# ---------------------------------------------------------------------------
# the decode weight tree
# ---------------------------------------------------------------------------
def _llama_decode_params(model, weight_only_int8: bool = False,
                         weight_only_quant=None):
    """The cached-decode weight tree of a LlamaForCausalLM: plain tensors
    (detached views of the parameters, no copies) keyed like the JAX
    package's tree, plus the config and the f32 rope tables."""
    if weight_only_int8 or weight_only_quant:
        raise NotImplementedError(
            "weight-only int8/int4 layouts are not ported yet (ROADMAP.md "
            "queue A item 4)")
    cfg = model.config
    inner = getattr(model, "llama", None)
    if inner is None:
        raise NotImplementedError(
            "the port serves the llama family only; the other families "
            "are ROADMAP.md queue A item 5")
    layers = []
    for lyr in inner.layers:
        a, m = lyr.self_attn, lyr.mlp
        layers.append(dict(
            ln1=lyr.input_layernorm.weight.detach(),
            wq=a.q_proj.weight.detach(), wk=a.k_proj.weight.detach(),
            wv=a.v_proj.weight.detach(), wo=a.o_proj.weight.detach(),
            ln2=lyr.post_attention_layernorm.weight.detach(),
            wg=m.gate_proj.weight.detach(), wu=m.up_proj.weight.detach(),
            wd=m.down_proj.weight.detach()))
    head = model.lm_head.weight.detach() if model.lm_head is not None \
        else None
    return dict(cfg=cfg, family="llama",
                embed=inner.embed_tokens.weight.detach(),
                layers=layers, norm=inner.norm.weight.detach(), head=head,
                cos=inner.rope_cos, sin=inner.rope_sin)


def _decode_params(model, weight_only_int8: bool = False,
                   weight_only_quant=None):
    """Family dispatch of the cached decode path: the llama family only
    (the gpt, MoE and MLA trees are ROADMAP.md queue A item 5)."""
    if getattr(model, "gpt", None) is not None \
            or getattr(model, "model", None) is not None:
        raise NotImplementedError(
            "cached decoding of the gpt, MoE and MLA families is not "
            "ported yet (ROADMAP.md queue A item 5)")
    return _llama_decode_params(model, weight_only_int8, weight_only_quant)


def _llama_weights(p):
    """The tensor slice of `_llama_decode_params` (no config, no family)."""
    return {k: v for k, v in p.items() if k not in ("cfg", "family")}


def _mm_w(h, L, key):
    """h @ the stored weight ``L[key]``: the one place the decode
    matmuls go through (the fp layout; the quantized layouts of queue A
    item 4 extend it)."""
    return h @ L[key]


def _ffn_apply(L, h2):
    """Dense SwiGLU FFN on [B, S, H]: down(silu(gate(h)) * up(h))."""
    return _mm_w(F.silu(_mm_w(h2, L, "wg")) * _mm_w(h2, L, "wu"), L, "wd")


# ---------------------------------------------------------------------------
# KV-cache decoding
# ---------------------------------------------------------------------------
def _llama_cached_step_body(cfg, max_len: int):
    """(weights, ids [B, S], caches, start) -> (last logits [B, V],
    caches). Writes the window's K/V into the caches at [start, start +
    S) in place. A multi-token window at start 0 (the prefill) attends
    causally over its fresh K/V through `sdpa_prefill`; any other window
    attends densely over the whole cache with positions past start + i
    masked, the GQA query heads grouped over their KV head so the cache
    is read once (no repeat)."""
    from .models.llama import apply_rope
    from .ops.flash_attention import sdpa_prefill
    Hh, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    eps = cfg.rms_norm_eps
    rep = Hh // KV

    def rms(h, w):
        var = h.float().square().mean(-1, keepdim=True)
        return (h * torch.rsqrt(var + eps).to(h.dtype)) * w

    def step(w, ids, caches, start: int):
        B, S = ids.shape
        x = w["embed"][ids]
        cos = w["cos"][start:start + S]
        sin = w["sin"][start:start + S]
        dev = x.device
        pos_k = torch.arange(max_len, device=dev)
        q_pos = start + torch.arange(S, device=dev)
        vis = pos_k[None, :] <= q_pos[:, None]            # [S, max_len]
        for L, (ck, cv) in zip(w["layers"], caches):
            h = rms(x, L["ln1"])
            q = apply_rope(_mm_w(h, L, "wq").reshape(B, S, Hh, D), cos, sin)
            k = apply_rope(_mm_w(h, L, "wk").reshape(B, S, KV, D), cos, sin)
            v = _mm_w(h, L, "wv").reshape(B, S, KV, D)
            ck[:, start:start + S] = k
            cv[:, start:start + S] = v
            if S > 1 and start == 0:
                kr = k.repeat_interleave(rep, 2) if rep > 1 else k
                vr = v.repeat_interleave(rep, 2) if rep > 1 else v
                o = sdpa_prefill(q, kr, vr, causal=True).reshape(
                    B, S, Hh * D)
            elif rep > 1:
                qg = q.reshape(B, S, KV, rep, D)
                scores = torch.einsum("bsgrd,btgd->bgrst", qg, ck) \
                    * (D ** -0.5)
                scores = torch.where(vis[None, None, None], scores.float(),
                                     torch.tensor(-1e30, device=dev))
                aw = torch.softmax(scores, dim=-1).to(cv.dtype)
                o = torch.einsum("bgrst,btgd->bsgrd", aw, cv).reshape(
                    B, S, Hh * D)
            else:
                scores = torch.einsum("bshd,bthd->bhst", q, ck) * (D ** -0.5)
                scores = torch.where(vis[None, None], scores.float(),
                                     torch.tensor(-1e30, device=dev))
                aw = torch.softmax(scores, dim=-1).to(cv.dtype)
                o = torch.einsum("bhst,bthd->bshd", aw, cv).reshape(
                    B, S, Hh * D)
            x = x + _mm_w(o, L, "wo")
            h2 = rms(x, L["ln2"])
            x = x + _ffn_apply(L, h2)
        x = rms(x, w["norm"])
        last = x[:, -1]
        return last @ (w["head"] if w["head"] is not None
                       else w["embed"].T), caches

    return step


def _cached_step_body(p, max_len: int):
    if p["family"] != "llama":
        raise NotImplementedError(
            f"cached decoding of the {p['family']} family is not ported "
            f"yet (ROADMAP.md queue A item 5)")
    return _llama_cached_step_body(p["cfg"], max_len)


def _init_caches(p, B: int, total: int):
    """Zero KV caches [B, total, KV, D] per layer, in the weights' dtype
    on their device."""
    cfg = p["cfg"]
    emb = p["embed"]
    shape = (B, total, cfg.num_key_value_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=emb.dtype, device=emb.device),
             torch.zeros(shape, dtype=emb.dtype, device=emb.device))
            for _ in p["layers"]]


def _make_cached_step(p, max_len: int):
    """The cached step over the weight tree: call(ids, caches, start)
    -> (last logits, caches). Eager: one body serves the prefill
    (start 0, the prompt's width) and every decode step (width 1)."""
    w = _llama_weights(p)
    body = _cached_step_body(p, max_len)

    def call(ids, caches, start: int):
        return body(w, ids, caches, start)
    return call


def generate_cached(model, input_ids, max_new_tokens: int = 20,
                    decode_strategy: str = "sampling",
                    top_k: Optional[int] = None, top_p: Optional[float] = None,
                    temperature: float = 1.0,
                    eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                    weight_only_int8: bool = False,
                    weight_only_quant=None,
                    deadline_s: Optional[float] = None,
                    generator: Optional[torch.Generator] = None):
    """KV-cache generation for LlamaForCausalLM: prefill once over the
    prompt, then O(1) work per new token. Returns (generated_ids,
    scores) as `generate` does, on the model's device; ``deadline_s`` as
    in `generate`. Greedy tokens equal `generate`'s under f32 (summation
    order aside, near-tied logits may flip in bf16)."""
    _check_strategy(decode_strategy)
    p = _decode_params(model, weight_only_int8, weight_only_quant)
    cfg = p["cfg"]
    dev = p["embed"].device
    ids = _as_ids(input_ids, dev)
    B, S0 = ids.shape
    total = S0 + max_new_tokens
    if total > cfg.max_position_embeddings:
        raise ValueError(f"{total} tokens exceed max_position_embeddings")
    caches = _init_caches(p, B, total)
    step = _make_cached_step(p, total)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    out_tokens, out_scores = [], []
    dl = _res.Deadline(deadline_s) if deadline_s else None
    timed_out = False
    with torch.no_grad():
        logits, caches = step(ids, caches, 0)          # prefill
        pos = S0
        while pos < total:
            tok = raw = _sample_token(logits, decode_strategy, top_k, top_p,
                                      temperature, generator)
            score = _score(logits, tok)
            if eos_token_id is not None:
                tok = torch.where(finished,
                                  torch.full_like(tok, pad_token_id), tok)
                score = torch.where(finished, torch.zeros_like(score), score)
                finished = finished | (tok == eos_token_id)
            out_tokens.append(tok)
            out_scores.append(score)
            if pos == total - 1 or (eos_token_id is not None
                                    and bool(finished.all())):
                break
            if dl is not None and dl.expired():
                timed_out = True
                break
            # a finished row's pad may lie outside the vocabulary, and its
            # logits are discarded: feed it the sampled id instead
            logits, caches = step(raw[:, None].long(), caches, pos)
            pos += 1
    partial = _finalize_tokens(out_tokens, out_scores, B, max_new_tokens,
                               pad_token_id, dev)
    if timed_out:
        return _timeout_result("generate_cached", dl, len(out_tokens),
                               partial)
    return partial
