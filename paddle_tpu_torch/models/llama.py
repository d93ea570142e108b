"""Llama model family (counterpart of paddle_tpu/models/llama.py).

The module tree and parameter names follow the JAX package exactly, so
``state_dict()`` keys equal ``paddle_tpu.jit.extract_state`` keys (for
example ``llama.layers.0.self_attn.q_proj.weight`` ``[H, H]`` and
``lm_head.weight`` ``[H, V]``) and weights carry over with
``paddle_tpu_torch.convert.load_reference_state``.

The tree holds the parameters and the f32 ``rope_cos`` / ``rope_sin``
tables that serving reads (``serving.ServingEngine``), and the eager
training forward: rms_norm and swiglu in the JAX op order
(``nn.functional``), rope in the working dtype, GQA by repeating K/V
heads before attention, attention through ``ops.flash_attention.sdpa``
(the flash kernel where its gate holds), and the token cross-entropy of
``distributed.ParallelCrossEntropy``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..distributed.parallel_layers import ParallelCrossEntropy
from ..distributed.recompute import dots_saveable, recompute
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F
from ..ops.flash_attention import sdpa, sdpa_reference

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "llama3_8b_config", "llama_tiny_config",
           "precompute_rope", "apply_rope"]


class LlamaConfig:
    """The JAX package's LlamaConfig, less its multi-device knobs
    (sequence / context parallelism, pack groups: ROADMAP.md queue A
    item 8). `use_flash_attention` routes attention through
    ``ops.flash_attention.sdpa`` (False: the dense composite
    ``sdpa_reference``); `recompute` checkpoints each decoder layer of
    ``LlamaModel.forward`` in training mode."""

    def __init__(self, vocab_size=128256, hidden_size=4096,
                 intermediate_size=14336, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=8,
                 max_position_embeddings=8192, rope_theta=500000.0,
                 rms_norm_eps=1e-5, initializer_range=0.02,
                 tie_word_embeddings=False, use_flash_attention=True,
                 recompute=False, fuse_attention_qkv=False,
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
        self.use_flash_attention = use_flash_attention
        self.recompute = recompute
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


def apply_rope(x, cos, sin):
    """Rotary embedding of x [B, S, H, D] with the half-split convention
    (x[..., :D/2], x[..., D/2:]); cos / sin [>= S, D/2] are cast to x's
    dtype before the products, as in the JAX package."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    S = x.shape[1]
    c = cos[None, :S, None, :].to(x.dtype)
    s = sin[None, :S, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


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
        self.c = c

    def forward(self, x, cos, sin, attn_mask=None):
        """x [B, S, hidden] -> [B, S, hidden]; attn_mask as `sdpa` takes
        it (a bool [B, S] key-padding mask rides the flash kernel's
        segment ids)."""
        c = self.c
        B, S, _ = x.shape
        H, KV, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        q = apply_rope(self.q_proj(x).reshape(B, S, H, D), cos, sin)
        k = apply_rope(self.k_proj(x).reshape(B, S, KV, D), cos, sin)
        v = self.v_proj(x).reshape(B, S, KV, D)
        rep = H // KV
        if rep > 1:  # query head h reads KV head h // rep
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        attend = sdpa if c.use_flash_attention else sdpa_reference
        o = attend(q, k, v, mask=attn_mask, causal=True)
        return self.o_proj(o.reshape(B, S, H * D))


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

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


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

    def forward(self, x, cos, sin, attn_mask=None):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return h + self.mlp(self.post_attention_layernorm(h))


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

    def forward(self, input_ids, attn_mask=None, remat=None):
        """Final-normed hidden states [B, S, hidden]. `remat` is the
        per-layer recompute policy: "none", "full" (checkpoint each
        layer) or "dots" (keep the matrix-product outputs, recompute the
        rest); None takes "full" when ``config.recompute`` is set and the
        module is in training mode, else "none"."""
        if remat is None:
            remat = "full" if self.config.recompute and self.training \
                else "none"
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be none|full|dots, got {remat!r}")
        policy = dots_saveable if remat == "dots" else None
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos, self.rope_sin
        for layer in self.layers:
            if remat == "none":
                x = layer(x, cos, sin, attn_mask)
            else:
                x = recompute(layer, x, cos, sin, attn_mask, policy=policy)
        return self.norm(x)


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
        """Logits [B, S, vocab]; with labels, (mean token loss, logits)."""
        h = self.llama(input_ids, attn_mask)
        if self.lm_head is not None:
            logits = self.lm_head(h)
        else:
            logits = h @ self.llama.embed_tokens.weight.T
        if labels is not None:
            tok_loss = ParallelCrossEntropy()(logits, labels)
            return tok_loss.mean(), logits
        return logits
