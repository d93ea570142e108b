"""paddle.incubate.nn.functional (counterpart of
paddle_tpu/incubate/nn/functional.py): the fused-op surface, each name
routed to the port's hand-written kernels where the JAX package routes to
its Pallas ones.

- ``fused_rms_norm`` / ``fused_layer_norm`` -> ``ops.fused_rms_norm`` /
  ``ops.fused_layer_norm``, differentiable (backwards in torch ops, the
  JAX rms VJP's op order; the layer norm's centred form);
- ``fused_rotary_position_embedding`` -> ``ops.fused_rope`` (B7);
- ``swiglu`` -> ``ops.swiglu`` (B8);
- ``weight_quantize`` / ``weight_only_linear`` -> ``ops.quant``;
- ``block_multihead_attention`` -> ``ops.paged_attention.paged_attention``;
- ``fused_multi_head_attention`` -> ``ops.flash_attention.sdpa`` (the
  flash kernel where its gate holds);
- ``fused_linear``, ``fused_bias_dropout_residual_layer_norm``,
  ``fused_feedforward`` and ``masked_multihead_attention``: torch ops in
  the JAX op order (the JAX package leaves them to XLA). The eval form of
  ``fused_bias_dropout_residual_layer_norm`` is the pattern the fusion
  pass rewrites to ``ops.fused_bias_residual_layer_norm`` (B9).

Dropout takes an explicit ``generator``; the JAX package's random stream
is not reproduced.
"""

from __future__ import annotations

import torch

from ... import ops
from ...nn import functional as F
from ...ops.fused import layer_norm_backward
from ...ops.paged_attention import paged_attention as _paged

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding", "swiglu",
           "weight_only_linear", "weight_quantize",
           "block_multihead_attention", "fused_linear",
           "fused_bias_dropout_residual_layer_norm", "fused_feedforward",
           "fused_multi_head_attention", "masked_multihead_attention"]


class _RmsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, eps):
        ctx.save_for_backward(x2, w)
        ctx.eps = eps
        return ops.fused_rms_norm(x2, w, eps=eps)

    @staticmethod
    def backward(ctx, g):
        # paddle_tpu/ops/fused.py:80-92, op for op
        x2, w = ctx.saved_tensors
        x, gf, wf = x2.float(), g.float(), w.float()
        r = torch.rsqrt((x * x).mean(-1, keepdim=True) + ctx.eps)
        xhat = x * r
        dw = (gf * xhat).sum(0).to(w.dtype)
        gw = gf * wf
        dx = r * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))
        return dx.to(x2.dtype), dw, None


class _LnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, b, eps):
        ctx.save_for_backward(x2, w, b)
        ctx.eps = eps
        return ops.fused_layer_norm(x2, w, b, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x2, w, b = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(x2.float(), g, w, ctx.eps)
        return dx.to(x2.dtype), dw.to(w.dtype), db.to(b.dtype), None


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """RMSNorm over the last axis by the fused_rms_norm kernel, plus
    norm_bias when given."""
    H = x.shape[-1]
    out = _RmsFn.apply(x.reshape(-1, H), norm_weight,
                       float(epsilon)).reshape(x.shape)
    return out if norm_bias is None else out + norm_bias


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1):
    """LayerNorm over the last axis by the fused_layer_norm kernel."""
    H = x.shape[-1]
    return _LnFn.apply(x.reshape(-1, H), norm_weight, norm_bias,
                       float(epsilon)).reshape(x.shape)


def fused_rotary_position_embedding(q, k, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """(q, k, v) with q / k rotated half-split by the fused_rope kernel;
    cos / sin [S, D/2], or Paddle's [S, D] tables, halved by taking every
    other column. As in the JAX package, the rotation is half-split
    whatever `use_neox_rotary_style` says. `position_ids` raises: the JAX
    package accepts and ignores it (ROADMAP.md queue C, C5)."""
    if position_ids is not None:
        raise NotImplementedError(
            "fused_rotary_position_embedding: position_ids is not "
            "supported; the JAX package accepts it and ignores it "
            "(ROADMAP.md queue C, C5). Gather the cos / sin rows of the "
            "positions before the call")
    if cos.shape[-1] == q.shape[-1]:
        cos, sin = cos[..., ::2], sin[..., ::2]
    qo, ko = ops.fused_rope(q, k, cos, sin)
    return qo, ko, v


def swiglu(x, y=None):
    """silu(x) * y by the swiglu kernel; with y None, x's last axis splits
    in half (read in place)."""
    return ops.swiglu(x, y)


def weight_quantize(x, algo: str = "weight_only_int8"):
    return ops.weight_quantize(x, algo)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype: str = "int8", arch=None):
    algo = ("weight_only_int4" if "int4" in str(weight_dtype)
            else "weight_only_int8")
    return ops.weight_only_linear(x, weight, weight_scale, bias=bias,
                                  algo=algo)


def block_multihead_attention(q, k_pages, v_pages, seq_lens, block_tables,
                              **kw):
    """Paged KV-cache decode attention (FLAGS_paged_impl's route)."""
    return _paged(q, k_pages, v_pages, seq_lens, block_tables)


def fused_linear(x, weight, bias=None, transpose_weight=False):
    out = x @ (weight.T if transpose_weight else weight)
    return out if bias is None else out + bias


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None, generator=None):
    """(x + bias) -> dropout -> + residual -> layer_norm. Normalization
    always runs; ln_scale / ln_bias are the optional affine parameters."""
    h = x if bias is None else x + bias
    if dropout_rate:
        # F.dropout owns the modes, downscale_in_infer's eval scaling too
        h = F.dropout(h, p=dropout_rate, training=training, mode=mode,
                      generator=generator)
    h = h + residual
    return F.layer_norm(h, h.shape[-1:], weight=ln_scale, bias=ln_bias,
                        epsilon=ln_epsilon)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, name=None,
                      generator=None):
    """Residual + (pre or post) layer_norm + linear-act-dropout-linear-
    dropout; the layer norm at the active position always runs."""
    residual = x
    h = x
    if pre_layer_norm:
        h = F.layer_norm(h, h.shape[-1:], weight=ln1_scale, bias=ln1_bias,
                         epsilon=ln1_epsilon)
    h = F.linear(h, linear1_weight, linear1_bias)
    h = getattr(F, activation)(h)
    if dropout1_rate:
        h = F.dropout(h, p=dropout1_rate, training=training,
                      generator=generator)
    h = F.linear(h, linear2_weight, linear2_bias)
    if dropout2_rate:
        h = F.dropout(h, p=dropout2_rate, training=training,
                      generator=generator)
    out = residual + h
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], weight=ln2_scale,
                           bias=ln2_bias, epsilon=ln2_epsilon)
    return out


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, num_heads=None, name=None,
                               generator=None):
    """[pre-LN] -> packed qkv projection (qkv_weight [3, H, D, E]) ->
    `ops.flash_attention.sdpa` -> output projection -> dropout ->
    + residual -> [post-LN]. With cache_kv [2, B, H, L, D] the new keys
    and values are appended and (out, new_cache_kv) returned."""
    from ...ops.flash_attention import sdpa
    residual = x
    h = x
    if pre_layer_norm:
        h = F.layer_norm(h, h.shape[-1:], weight=pre_ln_scale,
                         bias=pre_ln_bias, epsilon=pre_ln_epsilon)
    _, H, D, E = qkv_weight.shape
    B, S, _ = h.shape
    qkv = h @ qkv_weight.reshape(3 * H * D, E).T
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(-1)
    qkv = qkv.reshape(B, S, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    new_cache = None
    if cache_kv is not None:
        kc = torch.cat([cache_kv[0], k.transpose(1, 2)], dim=2)
        vc = torch.cat([cache_kv[1], v.transpose(1, 2)], dim=2)
        new_cache = torch.stack([kc, vc])
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    o = sdpa(q, k, v, mask=attn_mask,
             dropout_p=attn_dropout_rate if training else 0.0)
    out = F.linear(o.reshape(B, S, H * D), linear_weight, linear_bias)
    if dropout_rate:
        out = F.dropout(out, p=dropout_rate, training=training,
                        generator=generator)
    out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], weight=ln_scale,
                           bias=ln_bias, epsilon=ln_epsilon)
    return out if new_cache is None else (out, new_cache)


def masked_multihead_attention(x, cache_kv, src_mask=None, bias=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, seq_len=1,
                               rotary_emb_dims=0, use_neox_rotary_style=False,
                               name=None):
    """One decode step over a dense KV cache: x [B, 3 * H * D] packed
    qkv (plus bias), cache_kv [2, B, H, max_seq, D]; the step's K / V are
    written at `sequence_lengths` (or seq_len - 1) of a copy of the cache
    and (out [B, H * D], new_cache_kv) returned. src_mask [B, 1, 1,
    max_seq] is additive. Rotary and beam offsets raise, as in the JAX
    package."""
    if rotary_tensor is not None or rotary_emb_dims:
        raise NotImplementedError(
            "masked_multihead_attention: rotary embedding inside the kernel "
            "is not implemented — apply rope to q/k before packing x")
    if beam_cache_offset is not None:
        raise NotImplementedError(
            "masked_multihead_attention: beam_cache_offset not implemented")
    _, B, H, MS, D = cache_kv.shape
    xx = x if bias is None else x + bias.reshape(-1)
    qkv = xx.reshape(B, 3, H, D)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    if sequence_lengths is not None:
        pos = torch.as_tensor(sequence_lengths,
                              device=x.device).reshape(B).long()
    else:
        pos = torch.full((B,), seq_len - 1, dtype=torch.long,
                         device=x.device)
    bidx = torch.arange(B, device=x.device)
    cache = cache_kv.clone()
    cache[0, bidx, :, pos] = k
    cache[1, bidx, :, pos] = v
    keys, vals = cache[0], cache[1]
    logits = torch.einsum("bhd,bhsd->bhs", q, keys) * (D ** -0.5)
    valid = torch.arange(MS, device=x.device)[None, None, :] \
        <= pos[:, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    if src_mask is not None:
        logits = logits + src_mask.reshape(B, 1, MS)
    p = torch.softmax(logits.float(), -1).to(q.dtype)
    o = torch.einsum("bhs,bhsd->bhd", p, vals)
    return o.reshape(B, H * D), cache
