"""Qwen2 dense decoder family (counterpart of paddle_tpu/models/qwen2.py).

The Llama GQA backbone with the two Qwen2 signatures: the q/k/v
projections carry biases (o_proj does not; ``Qwen2Config.qkv_bias``),
and small configs tie the LM head to the token embedding. It reuses the
port's Llama layers (rope, the SwiGLU MLP, attention through
``ops.flash_attention.sdpa``) under the attribute name ``qwen2``, so
``state_dict()`` keys equal ``paddle_tpu.jit.extract_state`` keys
(``qwen2.layers.{i}.self_attn.q_proj.bias`` ...).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..distributed.parallel_layers import ParallelCrossEntropy
from ..nn import Linear
from .llama import LlamaConfig, LlamaModel

__all__ = ["Qwen2Config", "Qwen2Model", "Qwen2ForCausalLM",
           "qwen2_tiny_config"]


class Qwen2Config(LlamaConfig):
    """LlamaConfig with rope theta 1e6 by default and ``qkv_bias``."""

    def __init__(self, qkv_bias=True, **kw):
        kw.setdefault("rope_theta", 1000000.0)
        super().__init__(**kw)
        self.qkv_bias = qkv_bias


def qwen2_tiny_config(**kw) -> Qwen2Config:
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256,
                tie_word_embeddings=True)
    base.update(kw)
    return Qwen2Config(**base)


class Qwen2Model(LlamaModel):
    """LlamaModel over a Qwen2Config: its attention layers take the
    config's q/k/v biases."""


class Qwen2ForCausalLM(nn.Module):
    """Qwen2 causal LM; devices, dtypes and initializers as
    LlamaForCausalLM's (biases start at zero)."""

    def __init__(self, config: Qwen2Config, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.qwen2 = Qwen2Model(config, **kw)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias_attr=False, **kw)

    def forward(self, input_ids, labels=None, attn_mask=None):
        """Logits [B, S, vocab]; with labels, (mean token loss, logits)."""
        h = self.qwen2(input_ids, attn_mask)
        if self.lm_head is not None:
            logits = self.lm_head(h)
        else:
            logits = h @ self.qwen2.embed_tokens.weight.T
        if labels is not None:
            tok_loss = ParallelCrossEntropy()(logits, labels)
            return tok_loss.mean(), logits
        return logits
