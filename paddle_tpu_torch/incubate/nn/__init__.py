"""paddle.incubate.nn (counterpart of paddle_tpu/incubate/nn): the fused
functional surface (``functional``) and the fused transformer layers
over it. Parameter names and shapes are the JAX package's (``state_dict()``
keys = ``extract_state``'s), so ``convert.load_reference_state`` carries
its weights across. Constructors take ``device`` (None: the CUDA device,
raising without one), ``dtype`` and ``generator``; weights draw from the
JAX initializers (Xavier normal; the packed qkv weight from N(0,
sqrt(1 / E))), norm scales start at one and biases at zero."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from . import functional

__all__ = ["functional", "FusedLinear", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer"]


class _Params:
    """Parameter factory on one device / dtype / generator."""

    def __init__(self, device, dtype, generator):
        self.dev = resolve_device(device)
        self.dtype = dtype
        self.gen = generator if generator is not None else \
            torch.Generator(device=self.dev).manual_seed(0)

    def normal(self, shape, std):
        return nn.Parameter(torch.empty(shape, device=self.dev,
                                        dtype=self.dtype).normal_(
            0.0, std, generator=self.gen))

    def xavier(self, shape):
        return self.normal(shape, math.sqrt(2.0 / (shape[0] + shape[1])))

    def const(self, shape, value, attr=None):
        if attr is False:
            return None
        return nn.Parameter(torch.full(shape, value, device=self.dev,
                                       dtype=self.dtype))


class FusedLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        p = _Params(device, dtype, generator)
        self.transpose_weight = transpose_weight
        self.weight = p.xavier([out_features, in_features]
                               if transpose_weight
                               else [in_features, out_features])
        self.bias = p.const([out_features], 0.0, bias_attr)

    def forward(self, x):
        return functional.fused_linear(x, self.weight, self.bias,
                                       transpose_weight=self.transpose_weight)


class FusedMultiHeadAttention(nn.Module):
    """Self-attention block over `functional.fused_multi_head_attention`;
    qkv_weight [3, num_heads, head_dim, embed_dim]."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide "
                             f"embed_dim ({embed_dim})")
        if kdim is not None and kdim != embed_dim:
            raise ValueError("kdim must equal embed_dim (self-attention)")
        if vdim is not None and vdim != embed_dim:
            raise ValueError("vdim must equal embed_dim (self-attention)")
        if need_weights:
            raise ValueError("need_weights is not supported (ref parity)")
        p = _Params(device, dtype, generator)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.generator = p.gen
        E, H, D = embed_dim, num_heads, self.head_dim
        self.qkv_weight = p.normal([3, H, D, E], math.sqrt(2.0 / (2 * E)))
        self.qkv_bias = p.const([3, H, D], 0.0, qkv_bias_attr)
        self.linear_weight = p.xavier([E, E])
        self.linear_bias = p.const([E], 0.0, linear_bias_attr)
        self.pre_ln_scale = p.const([E], 1.0)
        self.pre_ln_bias = p.const([E], 0.0, pre_ln_bias_attr)
        self.ln_scale = p.const([E], 1.0)
        self.ln_bias = p.const([E], 0.0, ln_bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if (key is not None and key is not query) or \
                (value is not None and value is not query):
            raise ValueError("FusedMultiHeadAttention is self-attention "
                             "only: key/value must be None or the query")
        return functional.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self.epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, cache_kv=cache,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self.epsilon, training=self.training,
            num_heads=self.num_heads, generator=self.generator)


class FusedFeedForward(nn.Module):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        p = _Params(device, dtype, generator)
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.epsilon = epsilon
        self.generator = p.gen
        self.linear1_weight = p.xavier([d_model, dim_feedforward])
        self.linear1_bias = p.const([dim_feedforward], 0.0,
                                    linear1_bias_attr)
        self.linear2_weight = p.xavier([dim_feedforward, d_model])
        self.linear2_bias = p.const([d_model], 0.0, linear2_bias_attr)
        self.ln1_scale = p.const([d_model], 1.0)
        self.ln1_bias = p.const([d_model], 0.0, ln1_bias_attr)
        self.ln2_scale = p.const([d_model], 1.0)
        self.ln2_bias = p.const([d_model], 0.0, ln2_bias_attr)

    def forward(self, x):
        return functional.fused_feedforward(
            x, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.activation,
            ln1_epsilon=self.epsilon, ln2_epsilon=self.epsilon,
            pre_layer_norm=self.normalize_before, training=self.training,
            generator=self.generator)


class FusedTransformerEncoderLayer(nn.Module):
    """The fused attention block, then the fused feed-forward block."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, name=None,
                 *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        ad = dropout_rate if attn_dropout_rate is None else attn_dropout_rate
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=ad, normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        out = self.fused_attn(src, attn_mask=src_mask, cache=cache)
        if cache is not None:
            out, new_cache = out
            return self.ffn(out), new_cache
        return self.ffn(out)
