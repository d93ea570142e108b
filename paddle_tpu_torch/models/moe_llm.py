"""MoE decoder LM family, Qwen2-MoE / DeepSeekMoE pattern (counterpart of
paddle_tpu/models/moe_llm.py).

The Llama GQA backbone (the port's LlamaAttention, rope tables, norms)
with a routed MoE FFN (``incubate.moe.MoELayer``) in every layer past
the first ``first_k_dense_replace`` dense ones (``LlamaMLP``), under the
attribute name ``model``, so ``state_dict()`` keys equal
``paddle_tpu.jit.extract_state`` keys
(``model.layers.{i}.mlp.w_up`` [E, H, I], ``.gate_weight`` [H, E],
``.shared_up.weight`` ...). The LM head is never tied, as in JAX.
Constructors take ``device``, ``dtype`` and ``generator`` like the
port's Llama, so a 21B-parameter model is drawn directly in bf16 on the
card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..distributed.parallel_layers import ParallelCrossEntropy
from ..incubate.moe import MoELayer
from ..nn import Linear, RMSNorm
from .llama import LlamaAttention, LlamaConfig, LlamaMLP, LlamaModel

__all__ = ["MoEConfig", "MoEDecoderLayer", "MoEModel", "MoEForCausalLM",
           "qwen2_moe_tiny_config"]


class MoEConfig(LlamaConfig):
    """Llama backbone + the MoE FFN's knobs: moe_intermediate_size per
    expert, shared_expert_intermediate_size, num_experts, top_k, the
    router's aux weight, dense first-k layers (first_k_dense_replace)
    and the dropless switch."""

    def __init__(self, num_experts=8, top_k=2, moe_intermediate_size=None,
                 shared_expert_intermediate_size=0, capacity_factor=1.25,
                 aux_loss_weight=0.01, router_z_loss_weight=0.0,
                 first_k_dense_replace=0, moe_dropless=False, **kw):
        super().__init__(**kw)
        self.num_experts = num_experts
        self.top_k = top_k
        self.moe_intermediate_size = (moe_intermediate_size
                                      or self.intermediate_size)
        self.shared_expert_intermediate_size = shared_expert_intermediate_size
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.router_z_loss_weight = router_z_loss_weight
        self.first_k_dense_replace = first_k_dense_replace
        self.moe_dropless = moe_dropless


def qwen2_moe_tiny_config(**kw) -> MoEConfig:
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256,
                rope_theta=10000.0, num_experts=4, top_k=2,
                moe_intermediate_size=64,
                shared_expert_intermediate_size=64)
    base.update(kw)
    return MoEConfig(**base)


class MoEDecoderLayer(nn.Module):
    """Pre-norm decoder layer: attention, then the dense SwiGLU FFN
    (layers before first_k_dense_replace) or the routed MoE FFN."""

    def __init__(self, c: MoEConfig, layer_idx: int = 0, **kw):
        super().__init__()
        norm_kw = {k: v for k, v in kw.items() if k != "generator"}
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                       **norm_kw)
        self.self_attn = LlamaAttention(c, **kw)
        self.post_attention_layernorm = RMSNorm(c.hidden_size,
                                                c.rms_norm_eps, **norm_kw)
        if layer_idx < c.first_k_dense_replace:
            self.mlp = LlamaMLP(c, **kw)
        else:
            self.mlp = MoELayer(
                c.hidden_size, c.moe_intermediate_size, c.num_experts,
                top_k=c.top_k, capacity_factor=c.capacity_factor,
                activation="swiglu", dropless=c.moe_dropless,
                shared_expert_hidden=c.shared_expert_intermediate_size,
                z_loss_weight=c.router_z_loss_weight, **kw)

    def forward(self, x, cos, sin, attn_mask=None):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return h + self.mlp(self.post_attention_layernorm(h))


class MoEModel(LlamaModel):
    """LlamaModel whose layers are MoEDecoderLayers."""

    def _layer(self, config, index: int, **kw) -> nn.Module:
        return MoEDecoderLayer(config, index, **kw)

    def aux_loss(self):
        """Sum of the router aux losses of the last forward (None before
        one, or without routed layers)."""
        total = None
        for layer in self.layers:
            la = getattr(layer.mlp, "l_aux", None)
            if la is not None:
                total = la if total is None else total + la
        return total


class MoEForCausalLM(nn.Module):
    """MoE causal LM; devices, dtypes and initializers as
    LlamaForCausalLM's (the expert stacks as MoELayer's)."""

    def __init__(self, config: MoEConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.model = MoEModel(config, **kw)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias_attr=False, **kw)

    def forward(self, input_ids, labels=None, attn_mask=None):
        """Logits [B, S, vocab]; with labels, (mean token loss + the
        weighted router aux loss, logits)."""
        logits = self.lm_head(self.model(input_ids, attn_mask))
        if labels is not None:
            loss = ParallelCrossEntropy()(logits, labels).mean()
            aux = self.model.aux_loss()
            if aux is not None and self.config.aux_loss_weight:
                loss = loss + aux * self.config.aux_loss_weight
            return loss, logits
        return logits
