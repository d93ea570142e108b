"""DeepSeek-V2 family: multi-head latent attention (MLA) and a MoE FFN
(counterpart of paddle_tpu/models/deepseek.py).

Queries and keys / values are low-rank compressed (``q_lora_rank``,
``kv_lora_rank``), and position rides in a small decoupled rope sub-head:
one shared ``k_pe`` head and a ``q_pe`` tail per query head, so a token's
cache is its normalized latent [r] and its rope key [dr] instead of full
K / V. The module tree and parameter names are the JAX package's, so
``state_dict()`` keys equal ``paddle_tpu.jit.extract_state`` keys
(``model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight`` [H, r + dr],
``.kv_b_proj.weight`` [r, nh (dn + dv)], ``q_proj`` or ``q_a_proj`` /
``q_a_layernorm`` / ``q_b_proj`` ...) and weights carry over with
``convert.load_reference_state``.

The forward is the JAX one, in its op order: the latent and q-lora norms
as ``(h * rsqrt(mean(h^2) + eps)) * w`` with f32 statistics, rope on the
[B, S, heads, dr] tails in the working dtype, and attention through
``ops.flash_attention.sdpa_padded_heads`` (q / k of dn + dr and v of dv
zero-padded to one head dim the flash forward kernel takes) where
``use_flash_attention`` holds and no mask is given, else the dense
masked softmax. Decoding and serving read the decode tree of
``generation._mla_decode_params``, which absorbs kv_b into the query and
the output.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike
from ..incubate.moe import MoELayer
from ..nn import Linear, RMSNorm
from ..ops.flash_attention import sdpa, sdpa_padded_heads
from .llama import LlamaMLP, apply_rope, precompute_rope
from .moe_llm import MoEConfig, MoEForCausalLM, MoEModel

__all__ = ["DeepSeekV2Config", "MLAttention", "DeepSeekV2DecoderLayer",
           "DeepSeekV2Model", "DeepSeekV2ForCausalLM",
           "deepseek_v2_tiny_config"]

_NEG = -1e30


class DeepSeekV2Config(MoEConfig):
    """MoEConfig plus the MLA widths: ``q_lora_rank`` (None: a plain q
    projection), ``kv_lora_rank`` r, ``qk_nope_head_dim`` dn,
    ``qk_rope_head_dim`` dr and ``v_head_dim`` dv."""

    def __init__(self, q_lora_rank=None, kv_lora_rank=512,
                 qk_nope_head_dim=128, qk_rope_head_dim=64,
                 v_head_dim=128, **kw):
        super().__init__(**kw)
        self.q_lora_rank = q_lora_rank
        self.kv_lora_rank = kv_lora_rank
        self.qk_nope_head_dim = qk_nope_head_dim
        self.qk_rope_head_dim = qk_rope_head_dim
        self.v_head_dim = v_head_dim
        self.qk_head_dim = qk_nope_head_dim + qk_rope_head_dim


def deepseek_v2_tiny_config(**kw) -> DeepSeekV2Config:
    base = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4,
                intermediate_size=128, max_position_embeddings=64,
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16,
                num_experts=4, top_k=2, moe_intermediate_size=32,
                shared_expert_intermediate_size=32,
                first_k_dense_replace=1)
    base.update(kw)
    return DeepSeekV2Config(**base)


def mla_rms(h, w, eps: float):
    """The MLA norms' op order: f32 statistics, ``(h * rsqrt(var +
    eps)) * w`` with the rsqrt cast to h's dtype."""
    var = h.float().square().mean(-1, keepdim=True)
    return (h * torch.rsqrt(var + eps).to(h.dtype)) * w


class MLAttention(nn.Module):
    """Multi-head latent attention (DeepSeek-V2).

    x -> [q_a -> RMSNorm -> q_b] or q        per-head (nope | rope) queries
    x -> kv_a -> (c_kv | k_pe)               latent + shared rope key head
         c_kv -> RMSNorm -> kv_b              per-head (k_nope | v)
    attention over (nope | rope) q . k, value dim v_head_dim, then o_proj.
    """

    def __init__(self, c: DeepSeekV2Config, **kw):
        super().__init__()
        self.c = c
        norm_kw = {k: v for k, v in kw.items() if k != "generator"}
        nh = c.num_attention_heads
        dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        lin = dict(bias_attr=False, **kw)
        if c.q_lora_rank:
            self.q_a_proj = Linear(c.hidden_size, c.q_lora_rank, **lin)
            self.q_a_layernorm = RMSNorm(c.q_lora_rank, c.rms_norm_eps,
                                         **norm_kw)
            self.q_b_proj = Linear(c.q_lora_rank, nh * (dn + dr), **lin)
        else:
            self.q_proj = Linear(c.hidden_size, nh * (dn + dr), **lin)
        self.kv_a_proj_with_mqa = Linear(c.hidden_size, c.kv_lora_rank + dr,
                                         **lin)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps,
                                      **norm_kw)
        self.kv_b_proj = Linear(c.kv_lora_rank, nh * (dn + dv), **lin)
        self.o_proj = Linear(nh * dv, c.hidden_size, **lin)

    def forward(self, x, cos, sin, attn_mask=None):
        c = self.c
        B, S, _ = x.shape
        nh = c.num_attention_heads
        dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        r, eps = c.kv_lora_rank, c.rms_norm_eps
        if c.q_lora_rank:
            q = mla_rms(self.q_a_proj(x), self.q_a_layernorm.weight, eps)
            q = self.q_b_proj(q)
        else:
            q = self.q_proj(x)
        q = q.reshape(B, S, nh, dn + dr)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        kv_a = self.kv_a_proj_with_mqa(x)
        c_kv, k_pe = kv_a[..., :r], kv_a[..., r:]
        kv = self.kv_b_proj(mla_rms(c_kv, self.kv_a_layernorm.weight, eps))
        kv = kv.reshape(B, S, nh, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, :, None, :], cos, sin).expand(B, S, nh, dr)
        qh = torch.cat([q_nope, q_pe], -1)
        kh = torch.cat([k_nope, k_pe], -1)
        if c.use_flash_attention and attn_mask is None:
            if dv == dn + dr:
                o = sdpa(qh, kh, v, causal=True)
            else:
                o = sdpa_padded_heads(qh, kh, v, causal=True,
                                      scale=float(dn + dr) ** -0.5)
        else:
            scale = 1.0 / float(torch.tensor(dn + dr, dtype=torch.float32)
                                .sqrt())
            scores = torch.einsum("bsnd,btnd->bnst", qh, kh) * scale
            scores = scores.float()
            causal = torch.ones(S, S, dtype=torch.bool,
                                device=x.device).tril()
            neg = torch.tensor(_NEG, dtype=scores.dtype, device=x.device)
            scores = torch.where(causal[None, None], scores, neg)
            if attn_mask is not None:   # composed with causal, never replacing
                m = torch.as_tensor(attn_mask, device=x.device)
                if m.dtype == torch.bool:
                    scores = torch.where(m, scores, neg)
                else:
                    scores = scores + m.to(scores.dtype)
            w = torch.softmax(scores, dim=-1).to(v.dtype)
            o = torch.einsum("bnst,btnv->bsnv", w, v)
        return self.o_proj(o.reshape(B, S, nh * dv))


class DeepSeekV2DecoderLayer(nn.Module):
    """Pre-norm decoder layer: MLA, then the dense SwiGLU FFN (layers
    before first_k_dense_replace) or the routed MoE FFN."""

    def __init__(self, c: DeepSeekV2Config, layer_idx: int = 0, **kw):
        super().__init__()
        norm_kw = {k: v for k, v in kw.items() if k != "generator"}
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                       **norm_kw)
        self.self_attn = MLAttention(c, **kw)
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


class DeepSeekV2Model(MoEModel):
    """MoEModel whose layers are DeepSeekV2DecoderLayers and whose rope
    tables span the rope sub-head (qk_rope_head_dim)."""

    def __init__(self, config: DeepSeekV2Config, **kw):
        super().__init__(config, **kw)
        cos, sin = precompute_rope(config.qk_rope_head_dim,
                                   config.max_position_embeddings,
                                   config.rope_theta, kw["device"])
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def _layer(self, config, index: int, **kw) -> nn.Module:
        return DeepSeekV2DecoderLayer(config, index, **kw)


class DeepSeekV2ForCausalLM(MoEForCausalLM):
    """DeepSeek-V2 causal LM (untied head); devices, dtypes and
    initializers as MoEForCausalLM's. With labels in training mode, the
    loss adds the routed layers' aux loss at aux_loss_weight."""

    def __init__(self, config: DeepSeekV2Config, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(config, device=device, dtype=dtype,
                         generator=generator)

    def _backbone(self, config, **kw) -> nn.Module:
        return DeepSeekV2Model(config, **kw)

    def _aux_in_loss(self) -> bool:
        # the JAX DeepSeekV2ForCausalLM adds it in training mode only
        return self.training
