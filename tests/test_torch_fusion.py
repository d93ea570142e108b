"""The port's pattern-fusion pass (jit.fusion) and jit.to_static against
the JAX package's (paddle_tpu/jit/fusion.py).

The JAX pass matches a jaxpr; the port's matches the graph TorchDynamo
captures. For each program of tests/test_fusion_pass.py the port runs its
counterpart written in torch, and both must find the same patterns, by
name and count (the negative cases included), and give the same outputs
and gradients at the JAX test's own bars. Then the programs the pass
meets in the packages' models, at tiny widths, in grad mode (parameters
trainable, as the JAX measurement was taken) and without grad: Llama
(one swiglu a layer), the Qwen2-MoE tiny config, GPT, the incubate
FusedTransformerEncoderLayer (pre- and post-LN) and MoELayer (capacity
mode). BertModel is not ported (ROADMAP.md queue A, A5d).

Two differences are pinned, each named where it shows:
- C6 (ROADMAP.md queue C): the JAX moe_dispatch matcher finds the gate's
  einsum pair only where jnp.einsum's contraction path scales the
  one-hots by the gates (capacity C < experts E); the port finds it at
  every capacity.
- Under autograd the JAX pass leaves the norm chains to their ops when
  its eager tape records them; the port does so whenever autograd records
  rsqrt (jit/fusion.py's docstring), so a jax.grad taken outside `fuse`
  finds a bias_residual_ln that the port leaves when x requires grad.

Last, one Llama training step through `to_static` with
FLAGS_use_fusion_compiler equals the eager step."""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.flags import flags_guard
from paddle_tpu_torch.incubate import nn as inn
from paddle_tpu_torch.incubate.moe import MoELayer, top_k_gating
from paddle_tpu_torch.jit import fusion, not_to_static, to_static

R = np.random.RandomState(0)
B, H, S, D = 2, 2, 16, 8


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import paddle_tpu
    from paddle_tpu.jit import extract_state, functional_call
    from paddle_tpu.jit import fusion as jfusion
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, paddle=paddle_tpu, fusion=jfusion,
        extract_state=extract_state, functional_call=functional_call)


def jax_found(jx, fn, *args):
    # a fresh function object a trace: make_jaxpr caches by function, and
    # the JAX tape's grad mode is no part of that key
    closed = jx.jax.make_jaxpr(lambda *a: fn(*a))(*args)
    found = {n: len(m(closed.jaxpr)) for n, (m, _, _) in
             jx.fusion.PATTERNS.items()}
    return {n: c for n, c in found.items() if c}


def port_fuse(fn, *args):
    """(output, {pattern: found}, stats) of the port's fuse(fn)(*args)."""
    fusion.reset_stats()
    out = fusion.fuse(fn)(*args)
    st = fusion.stats()
    assert st["untraced"] == 0 and st["graphs"] >= 1
    return out, {n: c for n, c in st["found"].items() if c}, st


def _arrs(*shapes, dtype=np.float32, scale=1.0):
    return [(R.standard_normal(s) * scale).astype(dtype) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


# ---------------------------------------------------------------- programs
def jnaive(jx, D_):
    def f(q, k, v):
        logits = jx.jnp.einsum("bhqd,bhkd->bhqk", q, k) * (D_ ** -0.5)
        p = jx.jax.nn.softmax(logits, axis=-1)
        return jx.jnp.einsum("bhqk,bhkd->bhqd", p, v)
    return f


def tnaive(D_):
    def f(q, k, v):
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (D_ ** -0.5)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, v)
    return f


def jrms(jx):
    def f(x, w, eps=1e-6):
        x32 = x.astype(jx.jnp.float32)
        var = jx.jnp.mean(jx.jnp.square(x32), -1, keepdims=True)
        return (x32 * jx.jax.lax.rsqrt(var + eps)).astype(x.dtype) * w
    return f


def trms(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.square(x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def jbrln(jx, bias=True, scale=True):
    def f(x, r, b, w, lb):
        h = (x + b[None, :] if bias else x) + r
        mu = jx.jnp.mean(h, -1, keepdims=True)
        var = jx.jnp.mean(jx.jnp.square(h - mu), -1, keepdims=True)
        y = (h - mu) * jx.jax.lax.rsqrt(var + 1e-5)
        return y * w[None, :] + lb[None, :] if scale else y
    return f


def tbrln(bias=True, scale=True):
    def f(x, r, b, w, lb):
        h = (x + b[None, :] if bias else x) + r
        mu = h.mean(-1, keepdim=True)
        var = torch.square(h - mu).mean(-1, keepdim=True)
        y = (h - mu) * torch.rsqrt(var + 1e-5)
        return y * w[None, :] + lb[None, :] if scale else y
    return f


class TestSdpaPrograms:
    @pytest.mark.parametrize("D_", [8, 64])
    def test_naive_chain(self, jx, D_):
        """D 8: found and left (the Hopper flash gate takes 64 / 128 /
        192); D 64: rewritten to flash_sdpa(causal=False)."""
        args = _arrs(*[(B, H, S, D_)] * 3, scale=0.3)
        want = jax_found(jx, jnaive(jx, D_), *args)
        out, found, st = port_fuse(tnaive(D_), *_t(*args))
        assert found == want == {"sdpa": 1}
        assert st["rewritten"]["sdpa"] == int(D_ == 64)
        assert st["refused"]["sdpa"] == int(D_ == 8)
        ref = jnaive(jx, D_)(*args)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)

    def test_bf16_chain_through_converts(self, jx):
        args = _arrs(*[(B, H, S, D)] * 3, scale=0.3)
        jb = [jx.jnp.asarray(a).astype(jx.jnp.bfloat16) for a in args]
        tb = [t.to(torch.bfloat16) for t in _t(*args)]
        want = jax_found(jx, jnaive(jx, D), *jb)
        _, found, _ = port_fuse(tnaive(D), *tb)
        assert found == want == {"sdpa": 1}

    def test_non_sdpa_and_used_interiors(self, jx):
        a = np.zeros((4, 4), np.float32)
        assert jax_found(jx, lambda x, y: jx.jax.nn.softmax(
            x @ y, axis=-1).sum(), a, a) == {}
        _, found, _ = port_fuse(lambda x, y: torch.softmax(x @ y, -1).sum(),
                                *_t(a, a))
        assert found == {}

        def jboth(q, k, v):
            p = jx.jax.nn.softmax(
                jx.jnp.einsum("bhqd,bhkd->bhqk", q, k) * 0.5, axis=-1)
            return jx.jnp.einsum("bhqk,bhkd->bhqd", p, v), p

        def tboth(q, k, v):
            p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.5,
                              dim=-1)
            return torch.einsum("bhqk,bhkd->bhqd", p, v), p
        args = _arrs(*[(B, H, S, 64)] * 3, scale=0.3)
        assert jax_found(jx, jboth, *args) == {}
        (out, probs), found, st = port_fuse(tboth, *_t(*args))
        assert found == {} and st["graphs"] == 1
        ref_out, ref_p = jboth(*args)
        np.testing.assert_allclose(probs.numpy(), np.asarray(ref_p),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   rtol=1e-4, atol=1e-5)

    def test_to_static_and_grad(self, jx):
        args = _arrs(*[(B, H, S, 64)] * 3, scale=0.3)
        jf = jnaive(jx, 64)
        g_ref = jx.jax.grad(lambda q: jf(q, *args[1:]).sum())(
            jx.jnp.asarray(args[0]))
        q, k, v = _t(*args)
        q.requires_grad_()
        fusion.reset_stats()
        n = ops.flash_sdpa.plain_calls
        with flags_guard(use_fusion_compiler=True):
            out = to_static(tnaive(64))(q, k, v)
        out.sum().backward()
        assert fusion.stats()["rewritten"]["sdpa"] == 1
        assert ops.flash_sdpa.plain_calls == n + 1
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(jf(*args)), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(q.grad.numpy(), np.asarray(g_ref),
                                   rtol=1e-3, atol=1e-4)

    def test_surrounding_ops_and_flag_gated_layer(self, jx):
        args = _arrs(*[(B, H, S, 64)] * 3, scale=0.3)
        x = _arrs((3, 3))[0]

        def jmodel(x, q, k, v):
            return (jx.jnp.tanh(x).sum() + jnaive(jx, 64)(q, k, v).sum()) * 2.0

        def tmodel(x, q, k, v):
            return (torch.tanh(x).sum() + tnaive(64)(q, k, v).sum()) * 2.0
        assert jax_found(jx, jmodel, x, *args) == {"sdpa": 1}
        out, found, _ = port_fuse(tmodel, *_t(x, *args))
        assert found == {"sdpa": 1}
        np.testing.assert_allclose(float(out), float(jmodel(x, *args)),
                                   rtol=1e-5)

        class Attn(torch.nn.Module):
            def forward(self, q, k, v):
                return tnaive(64)(q, k, v)
        ref = Attn()(*_t(*args))
        fusion.reset_stats()
        with flags_guard(use_fusion_compiler=True):
            m = to_static(Attn())
            out = m(*_t(*args))
        assert fusion.stats()["rewritten"]["sdpa"] == 1
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)
        # without the flag the program is captured and left as written
        fusion.reset_stats()
        m = to_static(Attn())
        np.testing.assert_allclose(m(*_t(*args)).numpy(), ref.numpy(),
                                   rtol=1e-6, atol=1e-7)
        st = fusion.stats()
        assert st["graphs"] == 1 and sum(st["found"].values()) == 0

    def test_not_to_static_runs_eagerly_between_graphs(self):
        seen = []

        @not_to_static
        def eager(y):
            seen.append(torch.compiler.is_compiling())
            return y * 2.0

        def program(x):
            return eager(x + 1.0) - 1.0
        x = torch.arange(4.0)
        fusion.reset_stats()
        out = to_static(program)(x)
        torch.testing.assert_close(out, (x + 1.0) * 2.0 - 1.0)
        st = fusion.stats()
        # the graphs before and after the call; the call itself ran as
        # written, outside any capture
        assert seen == [False] and st["graphs"] == 2 and \
            st["untraced"] == 0, (seen, st)

    @pytest.mark.parametrize("option", [
        {"input_spec": [None]}, {"build_strategy": object()},
        {"backend": "CINN"}, {"full_graph": True}])
    def test_to_static_refuses_options_it_cannot_honour(self, option):
        with pytest.raises(NotImplementedError, match="not supported"):
            to_static(lambda x: x, **option)


class TestNormPrograms:
    def test_rmsnorm_f32_bf16_and_wrong_divisor(self, jx):
        x = R.standard_normal((4, 128)).astype(np.float32)
        w = R.standard_normal(128).astype(np.float32)
        assert jax_found(jx, jrms(jx), x, w) == {"rmsnorm": 1}
        fusion.reset_stats()
        out, found, st = port_fuse(trms, *_t(x, w))
        assert found == {"rmsnorm": 1} and st["rewritten"]["rmsnorm"] == 1
        np.testing.assert_allclose(out.numpy(), np.asarray(jrms(jx)(x, w)),
                                   rtol=2e-5, atol=2e-5)
        xb = jx.jnp.asarray(x).astype(jx.jnp.bfloat16)
        wb = jx.jnp.ones((128,), jx.jnp.bfloat16)
        assert jax_found(jx, jrms(jx), xb, wb) == {"rmsnorm": 1}
        out, found, _ = port_fuse(trms, _t(x)[0].bfloat16(),
                                  torch.ones(128, dtype=torch.bfloat16))
        assert found == {"rmsnorm": 1}
        np.testing.assert_allclose(
            out.float().numpy(),
            np.asarray(jrms(jx)(xb, wb), np.float32), rtol=2e-2, atol=2e-2)

        def jnot(x, w):
            x32 = x.astype(jx.jnp.float32)
            var = jx.jnp.sum(jx.jnp.square(x32), -1, keepdims=True) / 7.0
            return (x32 * jx.jax.lax.rsqrt(var + 1e-6)).astype(x.dtype) * w

        def tnot(x, w):
            x32 = x.float()
            var = torch.square(x32).sum(-1, keepdim=True) / 7.0
            return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * w
        ones = np.ones((4, 128), np.float32)
        assert jax_found(jx, jnot, ones, ones[0]) == {}
        assert port_fuse(tnot, *_t(ones, ones[0]))[1] == {}

    @pytest.mark.parametrize("form", ["full", "residual_only", "scalar"])
    def test_bias_residual_ln(self, jx, form):
        x, r = _arrs((8, 256), (8, 256))
        b, w, lb = _arrs(*[(256,)] * 3)
        if form == "full":
            jf, tf = jbrln(jx), tbrln()
        elif form == "residual_only":
            jf, tf = jbrln(jx, False, False), tbrln(False, False)
        else:
            # a scalar literal consumer beside the chain
            def jf(x, r, b, w, lb):
                return jbrln(jx, False, False)(x, r, b, w, lb) * 2.0

            def tf(x, r, b, w, lb):
                return tbrln(False, False)(x, r, b, w, lb) * 2.0
        assert jax_found(jx, jf, x, r, b, w, lb) == {"bias_residual_ln": 1}
        out, found, st = port_fuse(tf, *_t(x, r, b, w, lb))
        assert found == {"bias_residual_ln": 1}
        assert st["rewritten"]["bias_residual_ln"] == 1
        ref = jx.fusion.fuse(jf) if form == "full" else jf
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(ref(x, r, b, w, lb)),
                                   rtol=2e-5, atol=2e-5)

    def test_plain_ln_and_incubate_functional(self, jx):
        def jln(x):
            mu = jx.jnp.mean(x, -1, keepdims=True)
            var = jx.jnp.mean(jx.jnp.square(x - mu), -1, keepdims=True)
            return (x - mu) * jx.jax.lax.rsqrt(var + 1e-5)

        def tln(x):
            mu = x.mean(-1, keepdim=True)
            var = torch.square(x - mu).mean(-1, keepdim=True)
            return (x - mu) * torch.rsqrt(var + 1e-5)
        ones = np.ones((8, 128), np.float32)
        assert jax_found(jx, jln, ones) == {}
        assert port_fuse(tln, *_t(ones))[1] == {}

        from paddle_tpu.core.tensor import Tensor
        from paddle_tpu.incubate.nn import functional as jIF
        from paddle_tpu_torch.incubate.nn import functional as IF

        def jf(xa, ra, ba, wa, la):
            return jIF.fused_bias_dropout_residual_layer_norm(
                Tensor(xa), Tensor(ra), bias=Tensor(ba), ln_scale=Tensor(wa),
                ln_bias=Tensor(la), dropout_rate=0.0, training=False)._data

        def tf(x, r, b, w, lb):
            return IF.fused_bias_dropout_residual_layer_norm(
                x, r, bias=b, ln_scale=w, ln_bias=lb, dropout_rate=0.0,
                training=False)
        x, r = _arrs((4, 256), (4, 256))
        v = _arrs(*[(256,)] * 3)
        assert jax_found(jx, jf, x, r, *v) == {"bias_residual_ln": 1}
        n = ops.fused_bias_residual_layer_norm.plain_calls
        out, found, st = port_fuse(tf, *_t(x, r, *v))
        assert found == {"bias_residual_ln": 1}
        assert ops.fused_bias_residual_layer_norm.plain_calls == n + 1
        np.testing.assert_allclose(out.numpy(), np.asarray(jf(x, r, *v)),
                                   rtol=2e-5, atol=2e-5)


class TestSwigluAndBlock:
    def test_swiglu_and_silu_alone(self, jx):
        x, wg, wu = _arrs((4, 64), (64, 128), (64, 128))

        def jffn(x, wg, wu):
            return jx.jax.nn.silu(x @ wg) * (x @ wu)

        def tffn(x, wg, wu):
            return torch.nn.functional.silu(x @ wg) * (x @ wu)
        assert jax_found(jx, jffn, x, wg, wu) == {"swiglu": 1}
        n = ops.swiglu.plain_calls
        out, found, _ = port_fuse(tffn, *_t(x, wg, wu))
        assert found == {"swiglu": 1} and ops.swiglu.plain_calls == n + 1
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jx.fusion.fuse(jffn)(x, wg, wu)),
            rtol=2e-5, atol=2e-5)
        ones = np.ones((4, 8), np.float32)
        assert jax_found(jx, jx.jax.nn.silu, ones) == {}
        assert port_fuse(torch.nn.functional.silu, *_t(ones))[1] == {}

    def test_full_block_fuses_all_three(self, jx):
        B_, H_, S_, D_, F_ = 2, 2, 128, 64, 256
        HD = H_ * D_

        def block(np_, rms, silu, x, w1, wq, wk, wv, w2, wg, wu):
            h = rms(x, w1)
            q, k, v = ((h @ w).reshape(B_, S_, H_, D_).transpose(0, 2, 1, 3)
                       if np_ is not torch else
                       (h @ w).reshape(B_, S_, H_, D_).transpose(1, 2)
                       for w in (wq, wk, wv))
            att = jnaive(jx, D_) if np_ is not torch else tnaive(D_)
            o = att(q, k, v)
            o = (o.transpose(0, 2, 1, 3) if np_ is not torch
                 else o.transpose(1, 2)).reshape(B_, S_, HD)
            x = x + o
            h2 = rms(x, w2)
            return x + silu(h2 @ wg) * (h2 @ wu) @ np_.eye(F_)[:, :HD]

        rng = np.random.RandomState(0)
        args = [rng.standard_normal((B_, S_, HD)).astype(np.float32),
                np.ones(HD, np.float32),
                *(rng.standard_normal((HD, HD)).astype(np.float32) * 0.1
                  for _ in range(3)),
                np.ones(HD, np.float32),
                rng.standard_normal((HD, F_)).astype(np.float32) * 0.1,
                rng.standard_normal((HD, F_)).astype(np.float32) * 0.1]

        def jblock(*a):
            return block(jx.jnp, jrms(jx), jx.jax.nn.silu, *a)

        def tblock(*a):
            return block(torch, trms, torch.nn.functional.silu, *a)
        want = jax_found(jx, jblock, *args)
        out, found, st = port_fuse(tblock, *_t(*args))
        assert found == want == {"sdpa": 1, "rmsnorm": 2, "swiglu": 1}
        assert st["rewritten"] == {"sdpa": 1, "rmsnorm": 2, "swiglu": 1,
                                   "bias_residual_ln": 0, "moe_dispatch": 0}
        np.testing.assert_allclose(out.numpy(), np.asarray(jblock(*args)),
                                   rtol=3e-4, atol=3e-4)


class TestMoeDispatchPrograms:
    def test_gate_matches_and_numerics(self, jx):
        from paddle_tpu.incubate.moe import top_k_gating as jgating
        g = np.asarray(jx.jax.nn.softmax(
            jx.jnp.asarray(np.random.RandomState(2).standard_normal((16, 8)),
                           jx.jnp.float32), -1))
        assert jax_found(jx, lambda a: jgating(a, 2, 4), g) == \
            {"moe_dispatch": 1}
        n = ops.fused_moe_dispatch_combine.plain_calls
        (d, c, aux), found, _ = port_fuse(lambda a: top_k_gating(a, 2, 4),
                                          *_t(g))
        assert found == {"moe_dispatch": 1}
        assert ops.fused_moe_dispatch_combine.plain_calls == n + 1
        for got, ref in zip((d, c, aux), jx.fusion.fuse(
                lambda a: jgating(a, 2, 4))(g)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=1e-6, atol=1e-7)

    def test_c6_capacity_above_experts(self, jx):
        """C6: at C >= E the JAX einsum scales keep, not the one-hots,
        and the JAX matcher finds nothing; the port finds the pair."""
        from paddle_tpu.incubate.moe import top_k_gating as jgating
        g = np.asarray(jx.jax.nn.softmax(
            jx.jnp.asarray(np.random.RandomState(3).standard_normal((16, 4)),
                           jx.jnp.float32), -1))
        assert jax_found(jx, lambda a: jgating(a, 2, 10), g) == {}
        out, found, _ = port_fuse(lambda a: top_k_gating(a, 2, 10), *_t(g))
        assert found == {"moe_dispatch": 1}
        for got, ref in zip(out, jgating(g, 2, 10)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=1e-6, atol=1e-7)

    def test_unrelated_pair_not_matched(self, jx):
        a, b = np.ones((4, 2, 8), np.float32), np.ones((4, 2, 6), np.float32)
        assert jax_found(jx, lambda x, y: jx.jnp.einsum(
            "tke,tkc->tec", x, y), a, b) == {}
        assert port_fuse(lambda x, y: torch.einsum("tke,tkc->tec", x, y),
                         *_t(a, b))[1] == {}


class TestDifferentiate:
    def test_brln_and_gate_gradients(self, jx):
        def jf(x, r, w):
            h = x + r
            mu = jx.jnp.mean(h, -1, keepdims=True)
            var = jx.jnp.mean(jx.jnp.square(h - mu), -1, keepdims=True)
            return ((h - mu) * jx.jax.lax.rsqrt(var + 1e-5) * w).sum()

        def tf(x, r, w):
            h = x + r
            mu = h.mean(-1, keepdim=True)
            var = torch.square(h - mu).mean(-1, keepdim=True)
            return ((h - mu) * torch.rsqrt(var + 1e-5) * w).sum()
        rng = np.random.RandomState(5)
        x = rng.standard_normal((8, 256)).astype(np.float32)
        w = rng.standard_normal(256).astype(np.float32)
        g_ref = jx.jax.grad(jf, argnums=(0, 2))(x, x, w)
        assert jax_found(jx, jf, x, x, w) == {"bias_residual_ln": 1}
        # x requires grad: autograd records rsqrt, the port leaves the chain
        tx, tr, tw = _t(x, x, w)
        tx.requires_grad_(), tw.requires_grad_()
        out, found, _ = port_fuse(tf, tx, tr, tw)
        assert found == {}
        out.backward()
        for got, ref in zip((tx.grad, tw.grad), g_ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5)
        # only w requires grad: rewritten, w's gradient through B9's
        tx, tr, tw = _t(x, x, w)
        tw.requires_grad_()
        out, found, _ = port_fuse(tf, tx, tr, tw)
        assert found == {"bias_residual_ln": 1}
        out.backward()
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(g_ref[1]),
                                   rtol=1e-4, atol=1e-5)

        from paddle_tpu.incubate.moe import top_k_gating as jgating

        def jloss(g):
            d, c, _ = jgating(g, 2, 4)
            return (d * 0.5 + c).sum()

        def tloss(g):
            d, c, _ = top_k_gating(g, 2, 4)
            return (d * 0.5 + c).sum()
        gg = np.asarray(jx.jax.nn.softmax(jx.jnp.asarray(
            rng.standard_normal((16, 8)), jx.jnp.float32), -1))
        assert jax_found(jx, jloss, gg) == {"moe_dispatch": 1}
        tg = _t(gg)[0].requires_grad_()
        out, found, _ = port_fuse(tloss, tg)
        assert found == {"moe_dispatch": 1}
        out.backward()
        np.testing.assert_allclose(
            tg.grad.numpy(), np.asarray(jx.jax.grad(jloss)(gg)), rtol=1e-4,
            atol=1e-5)


# ------------------------------------------------------ the measured table
def _jax_program(jx, name):
    from paddle_tpu.incubate.moe import MoELayer as JMoELayer
    from paddle_tpu.incubate.nn import FusedTransformerEncoderLayer as JFtel
    from paddle_tpu.models.gpt import GPTForCausalLM, gpt_tiny_config
    from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu.models.moe_llm import (MoEForCausalLM,
                                           qwen2_moe_tiny_config)
    jx.paddle.seed(0)
    make = {"llama": lambda: LlamaForCausalLM(llama_tiny_config()),
            "moe": lambda: MoEForCausalLM(qwen2_moe_tiny_config()),
            "gpt": lambda: GPTForCausalLM(gpt_tiny_config()),
            "ftel_post": lambda: JFtel(32, 4, 64, dropout_rate=0.0),
            "ftel_pre": lambda: JFtel(32, 4, 64, dropout_rate=0.0,
                                      normalize_before=True),
            "moelayer": lambda: JMoELayer(32, 64, 4, top_k=2)}[name]
    m = make()
    if name.startswith("ftel"):
        m.eval()
    return m


def _port_program(name):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny_config
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.models.moe_llm import (MoEForCausalLM,
                                                 qwen2_moe_tiny_config)
    cpu = dict(device="cpu")
    make = {"llama": lambda: LlamaForCausalLM(llama_tiny_config(), **cpu),
            "moe": lambda: MoEForCausalLM(qwen2_moe_tiny_config(), **cpu),
            "gpt": lambda: GPTForCausalLM(gpt_tiny_config(), **cpu),
            "ftel_post": lambda: inn.FusedTransformerEncoderLayer(
                32, 4, 64, dropout_rate=0.0, **cpu),
            "ftel_pre": lambda: inn.FusedTransformerEncoderLayer(
                32, 4, 64, dropout_rate=0.0, normalize_before=True, **cpu),
            "moelayer": lambda: MoELayer(32, 64, 4, top_k=2, **cpu)}[name]
    m = make()
    if name.startswith("ftel"):
        m.eval()
    return m


#: what each pass finds, grad mode first (the JAX measurement's) then
#: without grad; the port's moe_dispatch beside JAX's 0 is C6 (C 10 > E 4)
TABLE = {
    "llama": ({"swiglu": 2}, {"rmsnorm": 5, "swiglu": 2}),
    "moe": ({"swiglu": 4}, {"rmsnorm": 5, "swiglu": 4}),
    "gpt": ({}, {"bias_residual_ln": 5}),
    "ftel_post": ({"sdpa": 1}, {"sdpa": 1, "bias_residual_ln": 2}),
    "ftel_pre": ({"sdpa": 1}, {"sdpa": 1, "bias_residual_ln": 1}),
    "moelayer": ({"swiglu": 1}, {"swiglu": 1}),
}
C6_PAIRS = {"moe": 2, "moelayer": 1}


@pytest.mark.parametrize("name", list(TABLE))
def test_measured_table(jx, name):
    """The patterns each pass finds in the packages' own programs."""
    ids = np.zeros((1, 16), np.int32)
    x = np.random.RandomState(0).standard_normal((2, 8, 32)).astype(
        np.float32)
    inp = ids if name in ("llama", "moe", "gpt") else x
    jm = _jax_program(jx, name)
    st = jx.extract_state(jm)

    def jf(st, a):
        out = jx.functional_call(jm, st, jx.paddle.to_tensor(a))
        return (out[0] if isinstance(out, tuple) else out)._data
    tm = _port_program(name)
    t_in = torch.from_numpy(inp).long() if inp is ids else _t(inp)[0]
    for grad, want in zip((True, False), TABLE[name]):
        if grad:
            jfound = jax_found(jx, jf, st, inp)
        else:
            with jx.paddle.no_grad():
                jfound = jax_found(jx, jf, st, inp)
        assert jfound == want
        with torch.set_grad_enabled(grad):
            _, found, st_p = port_fuse(tm, t_in)
        assert st_p["graphs"] == 1
        port_want = dict(want)
        if name in C6_PAIRS:
            port_want["moe_dispatch"] = C6_PAIRS[name]
        assert found == port_want


def test_llama_to_static_training_step_equals_eager():
    """One AdamW step of tiny Llama through to_static with the flag: the
    pass rewrites one swiglu a layer and the loss, gradients and updated
    weights equal the eager step's."""
    from paddle_tpu_torch import nn as pnn, optimizer
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    ids = torch.randint(0, 512, (2, 16),
                        generator=torch.Generator().manual_seed(2))
    labels = torch.roll(ids, -1, 1)
    runs = []
    for flagged in (False, True):
        m = LlamaForCausalLM(llama_tiny_config(), device="cpu",
                             generator=torch.Generator().manual_seed(1))
        opt = optimizer.AdamW(learning_rate=3e-4, parameters=m.parameters(),
                              weight_decay=0.1,
                              grad_clip=pnn.ClipGradByGlobalNorm(1.0))
        fusion.reset_stats()
        n = ops.swiglu.plain_calls
        if flagged:
            with flags_guard(use_fusion_compiler=True):
                to_static(m)
                loss, _ = m(ids, labels=labels)
        else:
            loss, _ = m(ids, labels=labels)
        loss.backward()
        grads = [p.grad.clone() for p in m.parameters()]
        opt.step()
        runs.append((float(loss), grads,
                     [p.detach().clone() for p in m.parameters()]))
        st = fusion.stats()
        if flagged:
            assert st["rewritten"] == {"sdpa": 0, "rmsnorm": 0, "swiglu": 2,
                                       "bias_residual_ln": 0,
                                       "moe_dispatch": 0}
            assert st["untraced"] == 0 and st["graphs"] == 1
            assert ops.swiglu.plain_calls == n + 2
        else:
            assert ops.swiglu.plain_calls == n
    (l0, g0, p0), (l1, g1, p1) = runs
    assert abs(l0 - l1) <= 2e-6 * abs(l0)
    for a, b in zip(g0 + p0, g1 + p1):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
