"""The port's incubate.nn surface and its four kernels against the JAX
package.

Seeded numpy inputs go through the JAX wrappers of ``ops/fused.py``
(Pallas in interpret mode on the CPU, as tests/test_fused_ops.py and
tests/test_oracles.py run them; forward and ``jax.vjp``) and the port's
wrappers on CPU tensors, which run the plain versions under the same
autograd Functions the card uses: ``swiglu`` (B8), ``fused_rope`` (B7),
``fused_bias_residual_layer_norm`` (B9) and ``fused_moe_dispatch_combine``
(B10). Then every name of ``incubate.nn.functional`` and the four fused
layers, their weights carried across by ``extract_state`` ->
``load_reference_state``. f32 at 2e-5 throughout; dropout is held at 0 or
in eval, since the two packages' random streams differ. C5 (ROADMAP.md
queue C): the port refuses ``position_ids``, which the JAX package
accepts and ignores.

The card checks of the four kernels are
tests/test_torch_ops.py::TestFusedKernelsOnCard."""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.incubate import nn as inn
from paddle_tpu_torch.incubate.nn import functional as IF

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import paddle_tpu
    from paddle_tpu.incubate import nn as jinn
    from paddle_tpu.incubate.nn import functional as jIF
    from paddle_tpu.jit import extract_state
    from paddle_tpu.ops import fused, references
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, paddle=paddle_tpu, fused=fused,
        refs=references, IF=jIF, nn=jinn, extract_state=extract_state)


def _rng(seed):
    return np.random.RandomState(seed)


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _vjp(jx, fn, args, cot):
    """fn's outputs and its cotangent-weighted gradients, jitted once."""
    def run(*a):
        out, pull = jx.jax.vjp(fn, *a)
        return out, pull(cot)
    out, grads = jx.jax.jit(run)(*(jx.jnp.asarray(a) for a in args))
    return out, grads


def _torch_grads(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    sum((o * torch.from_numpy(np.asarray(c))).sum()
        for o, c in zip(outs, cots)).backward()
    return out, [t.grad for t in ts]


class TestSwigluParity:
    @pytest.mark.parametrize("split", [False, True])
    def test_matches_jax(self, jx, split):
        r = _rng(1)
        if split:
            args = [r.standard_normal((2, 6, 80)).astype(np.float32)]
            fn_j = jx.fused.swiglu
        else:
            args = [r.standard_normal((12, 40)).astype(np.float32) * 3
                    for _ in range(2)]
            fn_j = jx.fused.swiglu
        cot = r.standard_normal(args[0].shape[:-1] + (40,)).astype(
            np.float32)
        want, wgrads = _vjp(jx, fn_j, args, jx.jnp.asarray(cot))
        n = ops.swiglu.plain_calls
        got, grads = _torch_grads(ops.swiglu, args, cot)
        assert ops.swiglu.plain_calls == n + 1
        _close(got, want)
        _close(got, jx.refs.swiglu_reference(
            *(jx.jnp.asarray(a) for a in args)))
        for g, w in zip(grads, wgrads):
            _close(g, w)


class TestRopeParity:
    def test_matches_jax(self, jx):
        r = _rng(2)
        q = r.standard_normal((2, 8, 4, 16)).astype(np.float32)
        k = r.standard_normal((2, 8, 2, 16)).astype(np.float32)
        ang = r.uniform(0, 6.3, (8, 8)).astype(np.float32)
        cos, sin = np.cos(ang), np.sin(ang)
        cot = (r.standard_normal(q.shape).astype(np.float32),
               r.standard_normal(k.shape).astype(np.float32))
        want, wgrads = _vjp(jx, lambda a, b: jx.fused.fused_rope(
            a, b, jx.jnp.asarray(cos), jx.jnp.asarray(sin)), [q, k],
            tuple(jx.jnp.asarray(c) for c in cot))
        n, nb = ops.fused_rope.plain_calls, ops.fused_rope_bwd.plain_calls
        got, grads = _torch_grads(
            lambda a, b: ops.fused_rope(a, b, torch.from_numpy(cos),
                                        torch.from_numpy(sin)), [q, k], cot)
        assert ops.fused_rope.plain_calls == n + 1
        assert ops.fused_rope_bwd.plain_calls == nb + 1
        for g, w in zip(got, want):
            _close(g, w)
        for g, w in zip(grads, wgrads):
            _close(g, w)
        # a longer table: its first S rows
        long_c = np.concatenate([cos, cos[:3]])
        long_s = np.concatenate([sin, sin[:3]])
        got2 = ops.fused_rope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(long_c),
                              torch.from_numpy(long_s))
        for g, w in zip(got2, want):
            _close(g, w)


class TestBiasResidualLnParity:
    @pytest.mark.parametrize("parts", ["all", "none", "weight"])
    def test_matches_jax(self, jx, parts):
        r = _rng(3)
        H = 48
        x = r.standard_normal((2, 6, H)).astype(np.float32)
        res = r.standard_normal((2, 6, H)).astype(np.float32) + 3.0
        vecs = [r.standard_normal(H).astype(np.float32) for _ in range(3)]
        use = {"all": (1, 1, 1), "none": (0, 0, 0),
               "weight": (0, 1, 0)}[parts]
        args = [x, res] + [v for v, u in zip(vecs, use) if u]

        def bind(f):
            def call(a, b, *rest):
                it = iter(rest)
                b_, w_, l_ = (next(it) if u else None for u in use)
                return f(a, b, bias=b_, weight=w_, ln_bias=l_, eps=1e-5)
            return call
        cot = r.standard_normal(x.shape).astype(np.float32)
        want, wgrads = _vjp(jx, bind(jx.fused.fused_bias_residual_layer_norm),
                            args, jx.jnp.asarray(cot))
        n = ops.fused_bias_residual_layer_norm.plain_calls
        got, grads = _torch_grads(bind(ops.fused_bias_residual_layer_norm),
                                  args, cot)
        assert ops.fused_bias_residual_layer_norm.plain_calls == n + 1
        _close(got, want)
        for g, w in zip(grads, wgrads):
            _close(g, w, dict(atol=5e-5, rtol=5e-5))


class TestMoeDispatchCombineParity:
    @pytest.mark.parametrize("binary", [True, False])
    def test_matches_jax(self, jx, binary):
        r = _rng(4)
        T, K, E, C = 10, 2, 6, 5
        if binary:
            keep = np.eye(E, dtype=np.float32)[r.randint(0, E, (T, K))]
            keep *= (r.uniform(size=(T, K, 1)) > 0.2)
            oh = np.eye(C, dtype=np.float32)[r.randint(0, C, (T, K))]
        else:
            keep = r.standard_normal((T, K, E)).astype(np.float32)
            oh = r.standard_normal((T, K, C)).astype(np.float32)
        gv = r.uniform(size=(T, K)).astype(np.float32)
        cot = (r.standard_normal((T, E, C)).astype(np.float32),
               r.standard_normal((T, E, C)).astype(np.float32))
        want, wgrads = _vjp(jx, jx.fused.fused_moe_dispatch_combine,
                            [keep, oh, gv],
                            tuple(jx.jnp.asarray(c) for c in cot))
        n = ops.fused_moe_dispatch_combine.plain_calls
        got, grads = _torch_grads(ops.fused_moe_dispatch_combine,
                                  [keep, oh, gv], cot)
        assert ops.fused_moe_dispatch_combine.plain_calls == n + 1
        for g, w in zip(got, want):
            _close(g, w)
        for g, w in zip(grads, wgrads):
            _close(g, w)


def _jt(jx, a, grad=False):
    t = jx.paddle.to_tensor(a)
    t.stop_gradient = not grad
    return t


def _np(t):
    return np.asarray(t._data)


class TestFunctionalAgainstJax:
    def test_norms(self, jx):
        r = _rng(5)
        x = r.standard_normal((3, 5, 32)).astype(np.float32)
        w, b = (r.standard_normal(32).astype(np.float32) for _ in range(2))
        jxx, jw = _jt(jx, x, True), _jt(jx, w, True)
        want = jx.IF.fused_rms_norm(jxx, jw, epsilon=1e-5)
        want.sum().backward()
        tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        got = IF.fused_rms_norm(tx, tw, epsilon=1e-5)
        got.sum().backward()
        _close(got, _np(want))
        _close(tx.grad, _np(jxx.grad))
        _close(tw.grad, _np(jw.grad), dict(atol=5e-5, rtol=5e-5))
        got = IF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                                norm_bias=torch.from_numpy(b))
        _close(got, _np(jx.IF.fused_rms_norm(_jt(jx, x), _jt(jx, w),
                                             norm_bias=_jt(jx, b))))
        got = IF.fused_layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
        _close(got, _np(jx.IF.fused_layer_norm(
            *(_jt(jx, a) for a in (x, w, b)))))

    @pytest.mark.parametrize("table", ["half", "full"])
    def test_rotary_position_embedding(self, jx, table):
        r = _rng(6)
        q = r.standard_normal((1, 8, 4, 16)).astype(np.float32)
        k = r.standard_normal((1, 8, 2, 16)).astype(np.float32)
        v = r.standard_normal((1, 8, 2, 16)).astype(np.float32)
        width = 8 if table == "half" else 16
        ang = r.uniform(0, 6.3, (8, width)).astype(np.float32)
        cos, sin = np.cos(ang), np.sin(ang)
        for neox in (True, False):
            want = jx.IF.fused_rotary_position_embedding(
                *(_jt(jx, a) for a in (q, k, v)), sin=_jt(jx, sin),
                cos=_jt(jx, cos), use_neox_rotary_style=neox)
            got = IF.fused_rotary_position_embedding(
                *(torch.from_numpy(a) for a in (q, k, v)),
                sin=torch.from_numpy(sin), cos=torch.from_numpy(cos),
                use_neox_rotary_style=neox)
            _close(got[0], _np(want[0]))
            _close(got[1], _np(want[1]))
            assert np.array_equal(got[2].numpy(), v)

    def test_position_ids_refused_c5(self, jx):
        r = _rng(7)
        q = r.standard_normal((1, 4, 2, 8)).astype(np.float32)
        cs = np.ones((4, 4), np.float32)
        # the reference accepts position_ids and ignores it
        pos = np.array([[3, 2, 1, 0]])
        a = jx.IF.fused_rotary_position_embedding(
            _jt(jx, q), _jt(jx, q), sin=_jt(jx, 0 * cs), cos=_jt(jx, cs),
            position_ids=_jt(jx, pos))
        b = jx.IF.fused_rotary_position_embedding(
            _jt(jx, q), _jt(jx, q), sin=_jt(jx, 0 * cs), cos=_jt(jx, cs))
        assert np.array_equal(_np(a[0]), _np(b[0]))
        with pytest.raises(NotImplementedError, match="C5"):
            IF.fused_rotary_position_embedding(
                torch.from_numpy(q), torch.from_numpy(q),
                sin=torch.zeros(4, 4), cos=torch.ones(4, 4),
                position_ids=torch.from_numpy(pos))

    def test_swiglu_and_linear(self, jx):
        r = _rng(8)
        x = r.standard_normal((4, 24)).astype(np.float32)
        y = r.standard_normal((4, 12)).astype(np.float32)
        _close(IF.swiglu(torch.from_numpy(x)), _np(jx.IF.swiglu(_jt(jx, x))))
        _close(IF.swiglu(torch.from_numpy(x[:, :12]), torch.from_numpy(y)),
               _np(jx.IF.swiglu(_jt(jx, x[:, :12]), _jt(jx, y))))
        w = r.standard_normal((24, 6)).astype(np.float32)
        b = r.standard_normal(6).astype(np.float32)
        for tw in (False, True):
            wa = w.T.copy() if tw else w
            _close(IF.fused_linear(torch.from_numpy(x), torch.from_numpy(wa),
                                   torch.from_numpy(b), transpose_weight=tw),
                   _np(jx.IF.fused_linear(_jt(jx, x), _jt(jx, wa),
                                          _jt(jx, b), transpose_weight=tw)))

    @pytest.mark.parametrize("dtype", ["int8", "int4"])
    def test_weight_only(self, jx, dtype):
        r = _rng(9)
        w = r.standard_normal((64, 32)).astype(np.float32)
        x = r.standard_normal((3, 64)).astype(np.float32)
        b = r.standard_normal(32).astype(np.float32)
        algo = f"weight_only_{dtype}"
        jq, js = jx.IF.weight_quantize(_jt(jx, w), algo)
        tq, ts = IF.weight_quantize(torch.from_numpy(w), algo)
        assert np.array_equal(tq.numpy(), _np(jq))
        _close(ts, _np(js))
        got = IF.weight_only_linear(torch.from_numpy(x), tq,
                                    bias=torch.from_numpy(b),
                                    weight_scale=ts, weight_dtype=dtype)
        want = jx.IF.weight_only_linear(_jt(jx, x), jq, bias=_jt(jx, b),
                                        weight_scale=js, weight_dtype=dtype)
        _close(got, _np(want), dict(atol=1e-4, rtol=1e-4))

    def test_block_multihead_attention(self, jx):
        r = _rng(10)
        B, H, KV, D, P, psz = 2, 4, 2, 16, 6, 4
        q = r.standard_normal((B, H, D)).astype(np.float32)
        kp, vp = (r.standard_normal((KV, P, psz, D)).astype(np.float32)
                  for _ in range(2))
        lens = np.array([5, 9], np.int32)
        tab = np.array([[1, 2, 0], [3, 4, 5]], np.int32)
        got = IF.block_multihead_attention(
            *(torch.from_numpy(a) for a in (q, kp, vp, lens, tab)))
        want = jx.IF.block_multihead_attention(
            *(_jt(jx, a) for a in (q, kp, vp, lens, tab)))
        _close(got, _np(want))

    @pytest.mark.parametrize("mode,rate", [("upscale_in_train", 0.0),
                                           ("downscale_in_infer", 0.5)])
    def test_bias_dropout_residual_layer_norm(self, jx, mode, rate):
        r = _rng(11)
        x, res = (r.standard_normal((2, 5, 32)).astype(np.float32)
                  for _ in range(2))
        b, w, lb = (r.standard_normal(32).astype(np.float32)
                    for _ in range(3))
        got = IF.fused_bias_dropout_residual_layer_norm(
            *(torch.from_numpy(a) for a in (x, res)),
            bias=torch.from_numpy(b), ln_scale=torch.from_numpy(w),
            ln_bias=torch.from_numpy(lb), dropout_rate=rate,
            training=False, mode=mode)
        want = jx.IF.fused_bias_dropout_residual_layer_norm(
            *(_jt(jx, a) for a in (x, res)), bias=_jt(jx, b),
            ln_scale=_jt(jx, w), ln_bias=_jt(jx, lb), dropout_rate=rate,
            training=False, mode=mode)
        _close(got, _np(want))

    @pytest.mark.parametrize("pre", [False, True])
    def test_feedforward_and_attention(self, jx, pre):
        r = _rng(12)
        E, F_, H = 32, 48, 4
        x = r.standard_normal((2, 6, E)).astype(np.float32)
        w1 = r.standard_normal((E, F_)).astype(np.float32) * 0.2
        w2 = r.standard_normal((F_, E)).astype(np.float32) * 0.2
        b1, s1, s2 = (r.standard_normal(n).astype(np.float32)
                      for n in (F_, E, E))
        kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, pre_layer_norm=pre,
                  activation="gelu")
        got = IF.fused_feedforward(
            torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
            linear1_bias=torch.from_numpy(b1), ln1_scale=torch.from_numpy(s1),
            ln2_scale=torch.from_numpy(s2), **kw)
        want = jx.IF.fused_feedforward(
            _jt(jx, x), _jt(jx, w1), _jt(jx, w2), linear1_bias=_jt(jx, b1),
            ln1_scale=_jt(jx, s1), ln2_scale=_jt(jx, s2), **kw)
        _close(got, _np(want))
        qkv_w = r.standard_normal((3, H, E // H, E)).astype(np.float32) * .2
        lin_w = r.standard_normal((E, E)).astype(np.float32) * 0.2
        qkv_b = r.standard_normal((3, H, E // H)).astype(np.float32)
        cache = r.standard_normal((2, 2, H, 3, E // H)).astype(np.float32)
        akw = dict(pre_layer_norm=pre, dropout_rate=0.0,
                   attn_dropout_rate=0.0, training=False)
        for c in (None, cache):
            got = IF.fused_multi_head_attention(
                torch.from_numpy(x), torch.from_numpy(qkv_w),
                torch.from_numpy(lin_w), qkv_bias=torch.from_numpy(qkv_b),
                cache_kv=None if c is None else torch.from_numpy(c), **akw)
            want = jx.IF.fused_multi_head_attention(
                _jt(jx, x), _jt(jx, qkv_w), _jt(jx, lin_w),
                qkv_bias=_jt(jx, qkv_b),
                cache_kv=None if c is None else _jt(jx, c), **akw)
            if c is None:
                _close(got, _np(want))
            else:
                _close(got[0], _np(want[0]))
                _close(got[1], _np(want[1]))

    def test_masked_multihead_attention(self, jx):
        r = _rng(13)
        B, H, D, MS = 2, 2, 8, 6
        x = r.standard_normal((B, 3 * H * D)).astype(np.float32)
        cache = r.standard_normal((2, B, H, MS, D)).astype(np.float32)
        bias = r.standard_normal(3 * H * D).astype(np.float32)
        lens = np.array([2, 4], np.int32)
        got = IF.masked_multihead_attention(
            torch.from_numpy(x), torch.from_numpy(cache),
            bias=torch.from_numpy(bias),
            sequence_lengths=torch.from_numpy(lens))
        want = jx.IF.masked_multihead_attention(
            _jt(jx, x), _jt(jx, cache), bias=_jt(jx, bias),
            sequence_lengths=_jt(jx, lens))
        _close(got[0], _np(want[0]))
        _close(got[1], _np(want[1]))
        assert np.array_equal(cache, np.asarray(want[1]._data)) is False
        for kw in (dict(rotary_emb_dims=1), dict(beam_cache_offset=x)):
            with pytest.raises(NotImplementedError):
                IF.masked_multihead_attention(torch.from_numpy(x),
                                              torch.from_numpy(cache), **kw)


class TestFusedLayersAgainstJax:
    def _carry(self, jx, jl, tl):
        load_reference_state(tl, {k: np.asarray(v) for k, v in
                                  jx.extract_state(jl).items()})

    @pytest.mark.parametrize("pre", [False, True])
    def test_encoder_layer(self, jx, pre):
        jx.paddle.seed(0)
        jl = jx.nn.FusedTransformerEncoderLayer(
            32, 4, 64, dropout_rate=0.0, normalize_before=pre)
        jl.eval()
        tl = inn.FusedTransformerEncoderLayer(
            32, 4, 64, dropout_rate=0.0, normalize_before=pre, device="cpu")
        tl.eval()
        self._carry(jx, jl, tl)
        x = _rng(14).standard_normal((2, 8, 32)).astype(np.float32)
        _close(tl(torch.from_numpy(x)), _np(jl(_jt(jx, x))))

    def test_linear_attention_feedforward(self, jx):
        jx.paddle.seed(1)
        x = _rng(15).standard_normal((2, 5, 16)).astype(np.float32)
        pairs = [
            (jx.nn.FusedLinear(16, 8), inn.FusedLinear(16, 8, device="cpu")),
            (jx.nn.FusedLinear(16, 8, transpose_weight=True),
             inn.FusedLinear(16, 8, transpose_weight=True, device="cpu")),
            (jx.nn.FusedMultiHeadAttention(16, 2, dropout_rate=0.0,
                                           attn_dropout_rate=0.0),
             inn.FusedMultiHeadAttention(16, 2, dropout_rate=0.0,
                                         attn_dropout_rate=0.0,
                                         device="cpu")),
            (jx.nn.FusedFeedForward(16, 24, dropout_rate=0.0,
                                    normalize_before=True),
             inn.FusedFeedForward(16, 24, dropout_rate=0.0,
                                  normalize_before=True, device="cpu"))]
        for jl, tl in pairs:
            self._carry(jx, jl, tl)
            assert sorted(tl.state_dict()) == sorted(jx.extract_state(jl))
            _close(tl(torch.from_numpy(x)), _np(jl(_jt(jx, x))))

    def test_layers_default_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (lambda: inn.FusedLinear(4, 4),
                     lambda: inn.FusedTransformerEncoderLayer(8, 2, 16)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
