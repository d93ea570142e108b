"""Decode weight tree and matmul helpers (counterpart of the parts of
paddle_tpu/generation.py that the serving engine reads).

Ported: `_llama_decode_params` (fp layout), `_llama_weights`, `_mm_w`
(fp branch) and `_ffn_apply` (dense SwiGLU). The weight-only int8/int4
layouts are ROADMAP.md queue A item 4 and raise here; the batch
``generate`` / ``generate_cached`` APIs are queue A item 3.
"""

from __future__ import annotations

from torch.nn import functional as F

__all__ = []


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


def _llama_weights(p):
    """The tensor slice of `_llama_decode_params` (no config, no family)."""
    return {k: v for k, v in p.items() if k not in ("cfg", "family")}


def _mm_w(h, L, key):
    """h @ the stored weight ``L[key]``: the one place the engine's
    matmuls go through (the fp layout; the quantized layouts of queue A
    item 4 extend it)."""
    return h @ L[key]


def _ffn_apply(L, h2):
    """Dense SwiGLU FFN on [B, S, H]: down(silu(gate(h)) * up(h))."""
    return _mm_w(F.silu(_mm_w(h2, L, "wg")) * _mm_w(h2, L, "wu"), L, "wd")
