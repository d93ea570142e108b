"""Text generation and the decode weight tree (counterpart of
paddle_tpu/generation.py: the llama family, with Qwen2, the gpt family
and the MoE family).

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
- `_decode_params`, `_llama_decode_params` (Llama and Qwen2, whose
  q/k/v biases ride as ``bq`` / ``bk`` / ``bv``), `_gpt_decode_params`
  (fused ``wqkv`` + ``bqkv``, LayerNorms with biases, the GELU MLP,
  learned positions ``pos``), `_moe_decode_params` (the MoE family:
  the llama attention backbone, and per layer the dense SwiGLU or the
  routed ``moe`` subtree with its f32-read router ``gate``, the expert
  stacks ``wge`` / ``wup`` / ``wdn`` and the ``shared`` expert, plus the
  per-layer routing knobs ``moe_static``), `_llama_weights`, `_mm_w`,
  `_dq`, `_ffn_apply` (dense SwiGLU, or the routed experts: every
  expert on every token at T <= 32, else dropless through the grouped
  GEMM): the weight tree the serving engine reads too, in the fp layout
  or, with ``weight_only_int8=True`` / ``weight_only_quant="int8"|
  "int4"``, the JAX package's weight-only deploy layouts byte for byte
  (`_woq_algo`, `_q8`): every 2-D matmul weight of the layers and the
  LM head as ``key_q`` (int8 [K, N]) or ``key_q4`` (packed int4 [K/2,
  N]) beside its f32 scale ``key_s``, the 3-D expert stacks per expert
  with scales [E, N] (the router stays fp). The gpt family stays fp, as
  in JAX (its quant knobs raise). The MLA family and its 2-D int4 whole
  reads raise naming item 5c. `generate_compiled` and the beam searches
  are not ported yet (queue A item 3).

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

import warnings
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
def _woq_algo(weight_only_int8, weight_only_quant):
    """Normalize the two public quant knobs to (algo, enabled)."""
    if weight_only_quant not in (None, "int8", "int4"):
        raise ValueError(
            f"weight_only_quant {weight_only_quant!r}: expected "
            "'int8' or 'int4'")
    if weight_only_quant:
        if weight_only_int8 and weight_only_quant != "int8":
            raise ValueError(
                "conflicting quant knobs: weight_only_int8=True with "
                f"weight_only_quant={weight_only_quant!r} — drop the "
                "bool or make them agree")
        return "weight_only_" + weight_only_quant, True
    return "weight_only_int8", bool(weight_only_int8)


#: the stored name of a weight leaf in each weight-only layout: key_q
#: (int8 [K, N]) or key_q4 (packed int4 [K/2, N]), beside its f32 scale
#: key_s [N]; an fp leaf is key itself
_SUFFIX = {"weight_only_int8": "_q", "weight_only_int4": "_q4"}


def _walgo(d, key):
    """The layout of weight leaf `key` of `d`: 'weight_only_int4',
    'weight_only_int8' or None (fp)."""
    for algo, suffix in _SUFFIX.items():
        if key + suffix in d:
            return algo
    return None


def _wq2(d, key):
    """(payload, scale) of weight leaf `key` of `d` in any layout, as the
    megakernels read it (fp: scale None)."""
    algo = _walgo(d, key)
    if algo is None:
        return d[key], None
    return d[key + _SUFFIX[algo]], d[key + "_s"]


def _q8(d, key, enabled: bool = True, algo: str = "weight_only_int8"):
    """Quantize d[key] in place to (int8 or packed-int4 values,
    per-out-channel f32 scale), the weight-only deploy transform: int8
    stores key_q [K, N], int4 key_q4 [K/2, N], both key_s [N]. A 3-D
    expert stack [E, K, N] quantizes expert by expert (the JAX package's
    vmap; one expert's f32 copy at a time) into [E, K(/2), N] with
    scales [E, N]. None entries and disabled calls are no-ops."""
    if not enabled or d.get(key) is None:
        return
    from .ops.quant import weight_quantize
    w = d.pop(key)
    if w.ndim == 3:
        per_expert = [weight_quantize(we, algo) for we in w]
        qw = torch.stack([q for q, _ in per_expert])
        sc = torch.stack([s for _, s in per_expert])
    else:
        qw, sc = weight_quantize(w, algo)
    d[key + _SUFFIX[algo]] = qw
    d[key + "_s"] = sc.float()


def _llama_decode_params(model, weight_only_int8: bool = False,
                         weight_only_quant=None):
    """The cached-decode weight tree of a LlamaForCausalLM or a
    Qwen2ForCausalLM (the same GQA backbone; Qwen2's q/k/v biases ride as
    the fp leaves ``bq`` / ``bk`` / ``bv``): plain tensors (detached
    views of the parameters, no copies) keyed like the JAX package's
    tree, plus the config and the f32 rope tables.

    ``weight_only_int8`` / ``weight_only_quant`` ('int8' or 'int4')
    quantize every 2-D matmul weight of the layers, and the LM head
    (whose fp entry then reads None), into the deploy layout
    (``_q8``): new tensors where the model's device is."""
    algo, enabled = _woq_algo(weight_only_int8, weight_only_quant)
    cfg = model.config
    inner = getattr(model, "llama", None)
    if inner is None:
        inner = getattr(model, "qwen2", None)
    if inner is None:
        raise NotImplementedError(
            "expected a Llama-family model (model.llama / model.qwen2); "
            "the MoE and MLA families are ROADMAP.md queue A item 5")
    layers = []
    for lyr in inner.layers:
        a, m = lyr.self_attn, lyr.mlp
        d = dict(
            ln1=lyr.input_layernorm.weight.detach(),
            wq=a.q_proj.weight.detach(), wk=a.k_proj.weight.detach(),
            wv=a.v_proj.weight.detach(), wo=a.o_proj.weight.detach(),
            ln2=lyr.post_attention_layernorm.weight.detach(),
            wg=m.gate_proj.weight.detach(), wu=m.up_proj.weight.detach(),
            wd=m.down_proj.weight.detach())
        if a.q_proj.bias is not None:           # Qwen2's q/k/v biases
            d["bq"] = a.q_proj.bias.detach()
            d["bk"] = a.k_proj.bias.detach()
            d["bv"] = a.v_proj.bias.detach()
        for k in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
            _q8(d, k, enabled, algo)
        layers.append(d)
    head = model.lm_head.weight.detach() if model.lm_head is not None \
        else None
    p = dict(cfg=cfg, family="llama",
             embed=inner.embed_tokens.weight.detach(),
             layers=layers, norm=inner.norm.weight.detach(), head=head,
             cos=inner.rope_cos, sin=inner.rope_sin)
    if enabled and head is not None:
        _q8(p, "head", True, algo)
        p["head"] = None
    return p


def _gpt_decode_params(model):
    """The cached-decode weight tree of a GPTForCausalLM: fused qkv
    (+bias), LayerNorms with biases, the GELU MLP, learned positions, no
    rope; detached views of the parameters, keyed like the JAX tree."""
    gpt = model.gpt
    layers = []
    for blk in gpt.h:
        layers.append(dict(
            ln1w=blk.ln_1.weight.detach(), ln1b=blk.ln_1.bias.detach(),
            wqkv=blk.attn.qkv.weight.detach(),
            bqkv=blk.attn.qkv.bias.detach(),
            wo=blk.attn.proj.weight.detach(),
            bo=blk.attn.proj.bias.detach(),
            ln2w=blk.ln_2.weight.detach(), ln2b=blk.ln_2.bias.detach(),
            wi=blk.mlp.fc_in.weight.detach(),
            bi=blk.mlp.fc_in.bias.detach(),
            wf=blk.mlp.fc_out.weight.detach(),
            bf=blk.mlp.fc_out.bias.detach()))
    head = model.lm_head.weight.detach() if model.lm_head is not None \
        else None
    return dict(cfg=model.config, family="gpt",
                embed=gpt.embed_tokens.weight.detach(),
                pos=gpt.embed_positions.weight.detach(),
                layers=layers, normw=gpt.ln_f.weight.detach(),
                normb=gpt.ln_f.bias.detach(), head=head)


def _mlp_params(lyr, enabled: bool = False,
                algo: str = "weight_only_int8"):
    """A layer's FFN weights: (weight dict, static routing knobs or
    None). Dense SwiGLU (the llama layout) or the routed MoE subtree
    ``moe``: the router ``gate`` [H, E] (always fp: a flipped top-k is a
    different program, not a rounding error), the expert stacks ``wge``
    / ``wup`` [E, H, I] and ``wdn`` [E, I, H] and the ``shared`` expert
    (``sg`` / ``su`` / ``sd``), quantized per expert / per matrix when
    ``enabled``; the knobs (top_k, renorm) stay out of the tree. Serving
    always routes dropless: a model trained in capacity mode warns."""
    from .incubate.moe import MoELayer
    m = lyr.mlp
    if isinstance(m, MoELayer):
        if m.activation != "swiglu":
            raise NotImplementedError(
                "cached MoE decode supports swiglu experts (the LM configs)")
        if not m.dropless:
            warnings.warn(
                "cached/compiled MoE decode always routes DROPLESS (no "
                "capacity drops — serving never discards tokens); this "
                "model trains in capacity mode, so cached decode can "
                "diverge from generate() near capacity overflow. Exactness "
                "vs the buffer path holds for moe_dropless=True models.",
                stacklevel=4)
        mo = dict(gate=m.gate_weight.detach(), wge=m.w_gate.detach(),
                  wup=m.w_up.detach(), wdn=m.w_down.detach())
        for k in ("wge", "wup", "wdn"):
            _q8(mo, k, enabled, algo)
        if m.shared_up is not None:
            sh = dict(sg=m.shared_gate.weight.detach(),
                      su=m.shared_up.weight.detach(),
                      sd=m.shared_down.weight.detach())
            for k in ("sg", "su", "sd"):
                _q8(sh, k, enabled, algo)
            mo["shared"] = sh
        return dict(moe=mo), dict(top_k=m.top_k, renorm=m.renormalize)
    d = dict(wg=m.gate_proj.weight.detach(), wu=m.up_proj.weight.detach(),
             wd=m.down_proj.weight.detach())
    for k in ("wg", "wu", "wd"):
        _q8(d, k, enabled, algo)
    return d, None


def _moe_decode_params(model, enabled: bool = False,
                       algo: str = "weight_only_int8"):
    """The cached-decode weight tree of a MoEForCausalLM: the llama
    attention backbone and, per layer, `_mlp_params`'s dense or routed
    FFN; ``moe_static`` holds each layer's routing knobs (None for a
    dense layer). Quantized like `_llama_decode_params`, the expert
    stacks per expert."""
    inner = model.model
    layers, moe_static = [], []
    for lyr in inner.layers:
        a = lyr.self_attn
        d = dict(
            ln1=lyr.input_layernorm.weight.detach(),
            wq=a.q_proj.weight.detach(), wk=a.k_proj.weight.detach(),
            wv=a.v_proj.weight.detach(), wo=a.o_proj.weight.detach(),
            ln2=lyr.post_attention_layernorm.weight.detach())
        for k in ("wq", "wk", "wv", "wo"):
            _q8(d, k, enabled, algo)
        mlp_w, mlp_st = _mlp_params(lyr, enabled, algo)
        d.update(mlp_w)
        layers.append(d)
        moe_static.append(mlp_st)
    p = dict(cfg=model.config, family="moe",
             embed=inner.embed_tokens.weight.detach(),
             layers=layers, norm=inner.norm.weight.detach(),
             head=model.lm_head.weight.detach(),
             cos=inner.rope_cos, sin=inner.rope_sin,
             moe_static=tuple(moe_static))
    if enabled:
        _q8(p, "head", True, algo)
        p["head"] = None
    return p


def _decode_params(model, weight_only_int8: bool = False,
                   weight_only_quant=None):
    """Family dispatch of the cached decode path: the gpt family (fp
    only, as in JAX), the MoE family (``model.model`` a MoEModel), the
    llama family with Qwen2; the MLA family is ROADMAP.md queue A item
    5c."""
    algo, enabled = _woq_algo(weight_only_int8, weight_only_quant)
    if getattr(model, "gpt", None) is not None:
        if enabled:
            raise NotImplementedError(
                "weight-only decode covers the llama and MoE families; the "
                "GPT family is fp (its fused-qkv + bias layout is not wired "
                "through the quant matmul helper), as in the JAX package")
        return _gpt_decode_params(model)
    inner = getattr(model, "model", None)
    if inner is not None:
        from .models.moe_llm import MoEModel
        if isinstance(inner, MoEModel):
            return _moe_decode_params(model, enabled, algo)
        raise NotImplementedError(
            "cached decoding of the MLA family (deepseek) is not ported "
            "yet (ROADMAP.md queue A item 5c)")
    return _llama_decode_params(model, weight_only_int8, weight_only_quant)


def _llama_weights(p):
    """The tensor slice of a decode tree (no config, family or routing
    knobs)."""
    return {k: v for k, v in p.items()
            if k not in ("cfg", "family", "moe_static")}


def _dq(d, key, dtype):
    """A stored weight read WHOLE in `dtype`: fp as it is, int8 as the
    JAX package's ``q.astype(dtype) * s.astype(dtype)`` (which XLA fuses
    into the consuming matmul), here one elementwise pass ``q * s`` that
    converts the int8 operand exactly on the fly and writes the weight in
    `dtype` (a 3-D expert stack with its [E, N] scales per expert). A
    3-D packed-int4 stack [E, K/2, N] interleaves its sign-extended
    nibble planes back to source-row order and scales in f32, as the JAX
    body does (plain array code there too). A 2-D packed-int4 whole read
    (the MLA absorbed kv_b, through ``int4_dequantize``) is the MLA
    family's (ROADMAP.md queue A item 5c)."""
    algo = _walgo(d, key)
    if algo == "weight_only_int4":
        q4, s = d[key + "_q4"], d[key + "_s"]
        if q4.ndim != 3:
            raise NotImplementedError(
                "a packed-int4 weight read whole (int4_dequantize, the MLA "
                "family) is not ported yet (ROADMAP.md queue A item 5c)")
        from .ops.quant import int4_planes
        lo, hi = int4_planes(q4)                        # [E, K/2, N]
        E, K2, N = q4.shape
        w = torch.stack([lo, hi], dim=2).reshape(E, 2 * K2, N)
        return (w.float() * s[:, None, :].float()).to(dtype)
    if algo == "weight_only_int8":
        q, s = d[key + "_q"], d[key + "_s"].to(dtype)
        return q * (s[:, None, :] if q.ndim == 3 else s)
    return d[key]


def _mm_w(h, L, key):
    """h @ the stored weight ``L[key]``, the one place every layout's
    decode matmul goes through: packed int4 through
    ``ops.quant.weight_only_linear`` (the kernel reads the packed bytes);
    fp and int8 as ``h @ _dq(...)``, a torch.matmul as the JAX package
    leaves it to XLA."""
    if _walgo(L, key) == "weight_only_int4":
        from .ops.quant import weight_only_linear
        return weight_only_linear(h, *_wq2(L, key), algo="weight_only_int4")
    return h @ _dq(L, key, h.dtype)


def _head(last, w):
    """The LM head's logits of the last rows: the quantized head through
    `_mm_w`, else the fp head, else the tied embedding."""
    if _walgo(w, "head"):
        return _mm_w(last, w, "head")
    return last @ (w["head"] if w["head"] is not None else w["embed"].T)


def _ffn_apply(L, h2, st=None):
    """A layer's FFN on [..., H]: dense SwiGLU, down(silu(gate(h)) *
    up(h)), or the routed experts (``L["moe"]``, routing knobs ``st``):
    the f32 router, then every expert on every token at T <= 32 tokens
    (`dense_expert_ffn`, the JAX body's switch) or the dropless grouped
    GEMMs above (the ``gmm`` kernel on the card), then the shared
    expert. The JAX body reads the shared expert's weights whole
    (``h @ _dq``); its int4 layout there goes through int4_dequantize and
    a matmul, here through `_mm_w` (``weight_only_linear``, the same
    function), so no int4 weight is read whole."""
    if "moe" not in L:
        return _mm_w(F.silu(_mm_w(h2, L, "wg")) * _mm_w(h2, L, "wu"), L,
                     "wd")
    from .incubate.moe import dense_expert_ffn, dropless_expert_ffn
    mo = L["moe"]
    H = h2.shape[-1]
    xt = h2.reshape(-1, H)
    gates = torch.softmax(xt.float() @ mo["gate"].float(), -1)
    dt = h2.dtype
    w = (_dq(mo, "wge", dt), _dq(mo, "wup", dt), _dq(mo, "wdn", dt))
    kw = dict(top_k=st["top_k"], renormalize=st["renorm"])
    if xt.shape[0] <= 32:
        y, _ = dense_expert_ffn(xt, gates, *w, **kw)
    else:
        y, _ = dropless_expert_ffn(xt, gates, *w, **kw)
    y = y.reshape(h2.shape).to(dt)
    if "shared" in mo:
        sh = mo["shared"]
        s = F.silu(_mm_w(h2, sh, "sg")) * _mm_w(h2, sh, "su")
        y = y + _mm_w(s, sh, "sd")
    return y


# ---------------------------------------------------------------------------
# KV-cache decoding
# ---------------------------------------------------------------------------
def _llama_cached_step_body(cfg, max_len: int, moe_static=None):
    """(weights, ids [B, S], caches, start) -> (last logits [B, V],
    caches); the MoE family's too (``moe_static``: each layer's routing
    knobs). Writes the
    window's K/V into the caches at [start, start + S) in place. A
    multi-token window at start 0 (the prefill) attends causally over its
    fresh K/V through `sdpa_prefill`; any other window attends densely
    over the whole cache with positions past start + i masked, the GQA
    query heads grouped over their KV head so the cache is read once (no
    repeat)."""
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
        sts = moe_static or (None,) * len(w["layers"])
        for L, (ck, cv), st in zip(w["layers"], caches, sts):
            h = rms(x, L["ln1"])
            q, k, v = (_mm_w(h, L, "wq"), _mm_w(h, L, "wk"),
                       _mm_w(h, L, "wv"))
            if "bq" in L:                      # Qwen2 qkv biases
                q, k, v = q + L["bq"], k + L["bk"], v + L["bv"]
            q = apply_rope(q.reshape(B, S, Hh, D), cos, sin)
            k = apply_rope(k.reshape(B, S, KV, D), cos, sin)
            v = v.reshape(B, S, KV, D)
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
            x = x + _ffn_apply(L, h2, st)
        x = rms(x, w["norm"])
        return _head(x[:, -1], w), caches

    return step


def _gpt_cached_step_body(cfg, max_len: int):
    """The GPT counterpart of `_llama_cached_step_body`: learned
    positions, LayerNorm with bias (f32 statistics, cast before the
    affine, the JAX body's op order), fused qkv + bias, tanh-GELU MLP;
    an MHA cache (KV heads == query heads). The prefill attends through
    `sdpa_prefill`, every other window densely over the cache."""
    from .nn.functional import gelu
    from .ops.flash_attention import sdpa_prefill
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_eps

    def ln(h, wt, b):
        h32 = h.float()
        mu = h32.mean(-1, keepdim=True)
        var = ((h32 - mu) * (h32 - mu)).mean(-1, keepdim=True)
        return ((h32 - mu) * torch.rsqrt(var + eps)).to(h.dtype) * wt + b

    def step(w, ids, caches, start: int):
        B, S = ids.shape
        x = w["embed"][ids] + w["pos"][start:start + S][None]
        dev = x.device
        pos_k = torch.arange(max_len, device=dev)
        q_pos = start + torch.arange(S, device=dev)
        vis = pos_k[None, :] <= q_pos[:, None]            # [S, max_len]
        for L, (ck, cv) in zip(w["layers"], caches):
            h = ln(x, L["ln1w"], L["ln1b"])
            q, k, v = (h @ L["wqkv"] + L["bqkv"]).chunk(3, dim=-1)
            q = q.reshape(B, S, nh, hd)
            k = k.reshape(B, S, nh, hd)
            v = v.reshape(B, S, nh, hd)
            ck[:, start:start + S] = k
            cv[:, start:start + S] = v
            if S > 1 and start == 0:
                o = sdpa_prefill(q, k, v, causal=True).reshape(B, S, -1)
            else:
                scores = torch.einsum("bshd,bthd->bhst", q, ck) \
                    * (hd ** -0.5)
                scores = torch.where(vis[None, None], scores.float(),
                                     torch.tensor(-1e30, device=dev))
                aw = torch.softmax(scores, dim=-1).to(cv.dtype)
                o = torch.einsum("bhst,bthd->bshd", aw, cv).reshape(
                    B, S, -1)
            x = x + (o @ L["wo"] + L["bo"])
            h2 = ln(x, L["ln2w"], L["ln2b"])
            x = x + (gelu(h2 @ L["wi"] + L["bi"], approximate=True)
                     @ L["wf"] + L["bf"])
        x = ln(x, w["normw"], w["normb"])
        return _head(x[:, -1], w), caches

    return step


def _cached_step_body(p, max_len: int):
    if p["family"] == "gpt":
        return _gpt_cached_step_body(p["cfg"], max_len)
    return _llama_cached_step_body(p["cfg"], max_len, p.get("moe_static"))


def _kv_geometry(p):
    """(KV heads, head dim) of a decode tree's cache: the gpt family's
    cache has a KV head per query head (its config has no
    num_key_value_heads)."""
    cfg = p["cfg"]
    if p["family"] == "gpt":
        return cfg.num_attention_heads, cfg.head_dim
    return cfg.num_key_value_heads, cfg.head_dim


def _init_caches(p, B: int, total: int):
    """Zero KV caches [B, total, KV, D] per layer, in the weights' dtype
    on their device."""
    emb = p["embed"]
    shape = (B, total) + _kv_geometry(p)
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
    """KV-cache generation for LlamaForCausalLM, Qwen2ForCausalLM,
    GPTForCausalLM and MoEForCausalLM (routed dropless): prefill once
    over the prompt, then O(1) work per new token. Returns (generated_ids,
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
