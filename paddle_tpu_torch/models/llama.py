"""Llama model family (counterpart of paddle_tpu/models/llama.py).

The module tree and parameter names follow the JAX package exactly, so
``state_dict()`` keys equal ``paddle_tpu.jit.extract_state`` keys (for
example ``llama.layers.0.self_attn.q_proj.weight`` ``[H, H]`` and
``lm_head.weight`` ``[H, V]``) and weights carry over with
``paddle_tpu_torch.convert.load_reference_state``.

In this slice the tree holds the parameters and the f32 ``rope_cos`` /
``rope_sin`` tables that serving reads (``serving.ServingEngine``). The
training forward needs the flash-attention kernel and is ROADMAP.md
queue A item 2; until then it raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..nn import Embedding, Linear, RMSNorm

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "llama3_8b_config", "llama_tiny_config", "precompute_rope"]

_FORWARD_TODO = ("the Llama training forward needs the flash-attention "
                 "kernel (ROADMAP.md queue A item 2); this slice serves "
                 "through paddle_tpu_torch.serving.ServingEngine")


class LlamaConfig:
    """The JAX package's LlamaConfig, less its training-only knobs
    (flash routing, sequence/context parallelism, recompute, pack
    groups), which arrive with the slices that use them."""

    def __init__(self, vocab_size=128256, hidden_size=4096,
                 intermediate_size=14336, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=8,
                 max_position_embeddings=8192, rope_theta=500000.0,
                 rms_norm_eps=1e-5, initializer_range=0.02,
                 tie_word_embeddings=False, fuse_attention_qkv=False,
                 fuse_attention_ffn=False, head_dim=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads
        self.max_position_embeddings = max_position_embeddings
        self.rope_theta = rope_theta
        self.rms_norm_eps = rms_norm_eps
        self.initializer_range = initializer_range
        self.tie_word_embeddings = tie_word_embeddings
        # the packed q|k|v and gate|up layouts of the JAX package's
        # pretraining are not ported; set, they raise at construction
        self.fuse_attention_qkv = fuse_attention_qkv
        self.fuse_attention_ffn = fuse_attention_ffn
        self.head_dim = head_dim if head_dim is not None \
            else hidden_size // num_attention_heads


def llama3_8b_config(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_tiny_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256,
                rope_theta=10000.0)
    base.update(kw)
    return LlamaConfig(**base)


def precompute_rope(head_dim: int, max_seq: int, theta: float,
                    device: DeviceLike = "cpu"):
    """(cos, sin) f32 tables ``[max_seq, head_dim / 2]``. Computed in
    f32 like the JAX package; PyTorch's and XLA's f32 cos/sin may differ
    in the last bit."""
    dev = torch.device(device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=dev) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def _no_fused_packs(c: LlamaConfig) -> None:
    if c.fuse_attention_qkv or c.fuse_attention_ffn:
        raise NotImplementedError(
            "the port supports the unfused Llama layout; the fused qkv/ffn "
            "packs are pretrain perf knobs (fuse_attention_qkv/ffn)")


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, **kw):
        super().__init__()
        _no_fused_packs(c)
        H, D, KV = c.num_attention_heads, c.head_dim, c.num_key_value_heads
        self.q_proj = Linear(c.hidden_size, H * D, bias_attr=False, **kw)
        self.k_proj = Linear(c.hidden_size, KV * D, bias_attr=False, **kw)
        self.v_proj = Linear(c.hidden_size, KV * D, bias_attr=False, **kw)
        self.o_proj = Linear(H * D, c.hidden_size, bias_attr=False, **kw)


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, **kw):
        super().__init__()
        _no_fused_packs(c)
        self.gate_proj = Linear(c.hidden_size, c.intermediate_size,
                                bias_attr=False, **kw)
        self.up_proj = Linear(c.hidden_size, c.intermediate_size,
                              bias_attr=False, **kw)
        self.down_proj = Linear(c.intermediate_size, c.hidden_size,
                                bias_attr=False, **kw)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, c: LlamaConfig, **kw):
        super().__init__()
        norm_kw = {k: v for k, v in kw.items() if k != "generator"}
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                       **norm_kw)
        self.self_attn = LlamaAttention(c, **kw)
        self.post_attention_layernorm = RMSNorm(c.hidden_size,
                                                c.rms_norm_eps, **norm_kw)
        self.mlp = LlamaMLP(c, **kw)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        with torch.no_grad():
            self.embed_tokens.weight.normal_(
                0.0, config.initializer_range, generator=kw["generator"])
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=kw["device"], dtype=kw["dtype"])
        cos, sin = precompute_rope(config.head_dim,
                                   config.max_position_embeddings,
                                   config.rope_theta, kw["device"])
        # f32 always, and not part of the state dict (the JAX package's
        # persistable=False): they are recomputed, never loaded
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, attn_mask=None):
        raise NotImplementedError(_FORWARD_TODO)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM. ``device=None`` resolves to ``"cuda"`` and raises
    when CUDA is absent; pass ``device="cpu"`` for the CPU. Parameters
    are drawn in ``dtype`` on the device from ``generator`` (a fresh
    ``torch.Generator`` seeded with 0 on that device when None): the
    embedding from N(0, initializer_range), projections from Xavier
    normal, norms at ones — the JAX package's initializers."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.llama = LlamaModel(config, **kw)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias_attr=False, **kw)

    def forward(self, input_ids, labels=None, attn_mask=None):
        raise NotImplementedError(_FORWARD_TODO)
