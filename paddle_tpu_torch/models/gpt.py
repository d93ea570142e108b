"""GPT model family (counterpart of paddle_tpu/models/gpt.py).

Learned absolute positions (no rope), pre-LN blocks with biased
linears, a tanh-GELU 4x MLP, a final LayerNorm and, by default, an LM
head tied to the token embedding. The module tree and parameter names
follow the JAX package exactly (``gpt.embed_tokens``,
``gpt.embed_positions``, ``gpt.h.{i}.ln_1 / attn.qkv / attn.proj / ln_2
/ mlp.fc_in / mlp.fc_out``, ``gpt.ln_f``), so ``state_dict()`` keys
equal ``paddle_tpu.jit.extract_state`` keys and weights carry over with
``paddle_tpu_torch.convert.load_reference_state``.

Attention is causal, through ``ops.flash_attention.sdpa`` (the flash
kernel where its gate holds); a user mask composes with the causal one.
The serving engine and ``generation.generate_cached`` read the
parameters and run their own bodies.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..distributed.parallel_layers import ParallelCrossEntropy
from ..distributed.recompute import recompute
from ..nn import Embedding, LayerNorm, Linear
from ..nn import functional as F
from ..ops.flash_attention import sdpa

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt2_small_config",
           "gpt3_6_7b_config", "gpt_tiny_config"]


class GPTConfig:
    """The JAX package's GPTConfig (its fields and defaults)."""

    def __init__(self, vocab_size=50304, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=None, max_position_embeddings=1024,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 initializer_range=0.02, layer_norm_eps=1e-5,
                 tie_word_embeddings=True, recompute=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.tie_word_embeddings = tie_word_embeddings
        self.recompute = recompute
        self.head_dim = hidden_size // num_attention_heads


def gpt2_small_config(**kw) -> GPTConfig:
    return GPTConfig(**kw)


def gpt3_6_7b_config(**kw) -> GPTConfig:
    base = dict(hidden_size=4096, num_hidden_layers=32,
                num_attention_heads=32, max_position_embeddings=2048)
    base.update(kw)
    return GPTConfig(**base)


def gpt_tiny_config(**kw) -> GPTConfig:
    base = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=64)
    base.update(kw)
    return GPTConfig(**base)


class GPTAttention(nn.Module):
    def __init__(self, c: GPTConfig, **kw):
        super().__init__()
        self.c = c
        H = c.hidden_size
        self.qkv = Linear(H, 3 * H, **kw)
        self.proj = Linear(H, H, **kw)

    def forward(self, x, attn_mask=None):
        B, S, H = x.shape
        nh, hd = self.c.num_attention_heads, self.c.head_dim
        q, k, v = (t.reshape(B, S, nh, hd)
                   for t in self.qkv(x).chunk(3, dim=-1))
        o = sdpa(q, k, v, mask=attn_mask, causal=True,
                 dropout_p=self.c.attention_probs_dropout_prob
                 if self.training else 0.0)
        return self.proj(o.reshape(B, S, H))


class GPTMLP(nn.Module):
    def __init__(self, c: GPTConfig, **kw):
        super().__init__()
        self.fc_in = Linear(c.hidden_size, c.intermediate_size, **kw)
        self.fc_out = Linear(c.intermediate_size, c.hidden_size, **kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, c: GPTConfig, **kw):
        super().__init__()
        norm_kw = {k: v for k, v in kw.items() if k != "generator"}
        self.ln_1 = LayerNorm(c.hidden_size, c.layer_norm_eps, **norm_kw)
        self.attn = GPTAttention(c, **kw)
        self.ln_2 = LayerNorm(c.hidden_size, c.layer_norm_eps, **norm_kw)
        self.mlp = GPTMLP(c, **kw)
        self.p = c.hidden_dropout_prob

    def forward(self, x, attn_mask=None):
        drop = nn.functional.dropout
        x = x + drop(self.attn(self.ln_1(x), attn_mask), self.p,
                     self.training)
        return x + drop(self.mlp(self.ln_2(x)), self.p, self.training)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.embed_tokens = Embedding(config.vocab_size, H, **kw)
        self.embed_positions = Embedding(config.max_position_embeddings, H,
                                         **kw)
        with torch.no_grad():
            for emb in (self.embed_tokens, self.embed_positions):
                emb.weight.normal_(0.0, config.initializer_range,
                                   generator=kw["generator"])
        self.h = nn.ModuleList([GPTBlock(config, **kw)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(H, config.layer_norm_eps, device=kw["device"],
                              dtype=kw["dtype"])

    def forward(self, input_ids, position_ids=None, attn_mask=None):
        """Final-normed hidden states [B, S, hidden]."""
        S = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(S, device=input_ids.device)[None]
        x = self.embed_tokens(input_ids) + self.embed_positions(position_ids)
        x = nn.functional.dropout(x, self.config.hidden_dropout_prob,
                                  self.training)
        for block in self.h:
            if self.config.recompute and self.training:
                x = recompute(block, x, attn_mask)
            else:
                x = block(x, attn_mask)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT causal LM. ``device=None`` resolves to ``"cuda"`` and raises
    when CUDA is absent; pass ``device="cpu"`` for the CPU. Parameters
    are drawn in ``dtype`` on the device from ``generator`` (a fresh
    ``torch.Generator`` seeded with 0 on that device when None): both
    embeddings from N(0, initializer_range), linears from Xavier normal
    with zero biases, LayerNorms at ones and zeros — the JAX package's
    initializers."""

    def __init__(self, config: GPTConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.gpt = GPTModel(config, **kw)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias_attr=False, **kw)

    def forward(self, input_ids, labels=None, position_ids=None,
                attn_mask=None):
        """Logits [B, S, vocab]; with labels, (mean token loss, logits)."""
        h = self.gpt(input_ids, position_ids, attn_mask)
        if self.lm_head is not None:
            logits = self.lm_head(h)
        else:
            logits = h @ self.gpt.embed_tokens.weight.T
        if labels is not None:
            tok_loss = ParallelCrossEntropy()(logits, labels)
            return tok_loss.mean(), logits
        return logits
