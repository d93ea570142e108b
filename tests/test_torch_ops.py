"""The port's three serving kernels against the JAX package, and the card
checks of the four incubate kernels and of the generic elementwise kernel
(its plain version's parity with the JAX pass is in
test_torch_inference.py).

(fused_layer_norm's parity with the JAX kernel is in test_torch_gpt.py;
its card test is here.) For fused_rms_norm, fused_rope_append and
ragged_paged_attention, seeded
numpy inputs go through the JAX kernel (Pallas in interpret mode on the
CPU, as tests/test_ragged_kernel.py runs it), the JAX reference and the
port's wrapper on CPU tensors, which runs its plain PyTorch version. All
in f32 at 2e-5 atol/rtol, the bar of tests/test_ragged_kernel.py. Pools
are compared with the trash page 0 excluded: idle rows write duplicate
garbage there.

`TestKernelsOnCard` holds each CUDA kernel against its plain version on
the card; it needs one and skips elsewhere. On the machine with the card,
which has no JAX: python -m pytest --noconftest tests/test_torch_ops.py
-m cuda."""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import (fused_layer_norm, fused_rms_norm,
                                  fused_rope_append, ragged_paged_attention)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: kernels (interpret mode on the CPU) and references.
    Imported here, not at the top, so that the card-only class below runs
    on a machine without JAX (`python -m pytest --noconftest
    tests/test_torch_ops.py -m cuda`)."""
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.ops import fused, pallas_ragged, references
    return types.SimpleNamespace(
        jnp=jnp, rms_norm=fused.fused_rms_norm,
        rms_ref=references.rms_norm_reference,
        rope_append=fused.fused_rope_append,
        rope_append_ref=references.rope_append_reference,
        ragged=pallas_ragged.ragged_paged_attention,
        ragged_ref=pallas_ragged.ragged_attention_reference)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, *refs):
    for ref in refs:
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


# ---------------------------------------------------------------- rms_norm
class TestRmsNormParity:
    @pytest.mark.parametrize("shape,w_scale", [
        ((7, 128), 1.0),          # the tiny engine's rows
        ((1, 5, 96), 0.5),        # [1, T, H] as the engine calls it
        ((3, 4, 256), 2.0),
    ])
    def test_matches_jax(self, jx, shape, w_scale):
        jnp = jx.jnp
        rng = np.random.RandomState(0)
        x = rng.randn(*shape).astype(np.float32) * 3
        w = (rng.randn(shape[-1]) * w_scale).astype(np.float32)
        eps = 1e-5
        before = fused_rms_norm.plain_calls
        got = fused_rms_norm(_t(x), _t(w), eps)
        assert fused_rms_norm.plain_calls == before + 1
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        _close(got.numpy(), jx.rms_norm(jnp.asarray(x), jnp.asarray(w), eps),
               jx.rms_ref(jnp.asarray(x), jnp.asarray(w), eps))

    def test_bf16_input_f32_weight(self, jx):
        jnp = jx.jnp
        # the JAX kernel casts the weight to f32 beside bf16 rows
        rng = np.random.RandomState(1)
        x = rng.randn(4, 64).astype(np.float32)
        w = rng.randn(64).astype(np.float32)
        got = fused_rms_norm(_t(x).bfloat16(), _t(w), 1e-6)
        ref = jx.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                          1e-6)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------- rope_append
def _rope_inputs(T, Hq, KV, D, psz, total, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    return (f(T, Hq, D), f(T, KV, D), f(T, KV, D), f(T, D // 2),
            f(T, D // 2), f(KV, total, psz, D), f(KV, total, psz, D))


class TestRopeAppendParity:
    @pytest.mark.parametrize("pg,off", [
        # engine-shaped page walk: decode rows on distinct pages, idle row
        # on trash 0, then an adjacent prefill run sharing pages
        ([3, 5, 0, 7, 7, 7, 8], [1, 3, 0, 0, 1, 2, 0]),
        # every row idle but one: duplicate trash writes
        ([0, 0, 4, 0, 0, 0, 0], [0, 0, 2, 0, 0, 0, 0]),
    ])
    def test_matches_jax(self, jx, pg, off):
        T, Hq, KV, D, psz, total = 7, 4, 2, 64, 4, 9
        q, k, v, cos, sin, kp, vp = _rope_inputs(T, Hq, KV, D, psz, total,
                                                 seed=0)
        pg = np.asarray(pg, np.int32)
        off = np.asarray(off, np.int32)
        jargs = [jx.jnp.asarray(a) for a in (q, k, v, cos, sin, kp, vp, pg,
                                             off)]
        jq, jkp, jvp = jx.rope_append(*jargs)
        rq, rkp, rvp = jx.rope_append_ref(*jargs)
        tkp, tvp = _t(kp), _t(vp)
        before = fused_rope_append.plain_calls
        oq, okp, ovp = fused_rope_append(_t(q), _t(k), _t(v), _t(cos),
                                         _t(sin), tkp, tvp,
                                         _t(pg).long(), _t(off))
        assert fused_rope_append.plain_calls == before + 1
        # the pools are updated in place and returned as the same tensors
        assert okp is tkp and ovp is tvp
        _close(oq.numpy(), jq, rq)
        _close(okp.numpy()[:, 1:], np.asarray(jkp)[:, 1:],
               np.asarray(rkp)[:, 1:])
        np.testing.assert_array_equal(ovp.numpy()[:, 1:],
                                      np.asarray(rvp)[:, 1:])

    def test_identity_rope_is_a_pure_append(self):
        # cos=1 / sin=0 (the JAX GPT family's pure append): bitwise
        T, KV, D, psz, total = 4, 2, 32, 4, 5
        q, k, v, _, _, kp, vp = _rope_inputs(T, 4, KV, D, psz, total, 1)
        pg = np.asarray([1, 2, 3, 4], np.int32)
        off = np.asarray([0, 1, 2, 3], np.int32)
        oq, okp, ovp = fused_rope_append(
            _t(q), _t(k), _t(v), torch.ones(T, D // 2),
            torch.zeros(T, D // 2), _t(kp), _t(vp), _t(pg), _t(off))
        np.testing.assert_array_equal(oq.numpy(), q)
        np.testing.assert_array_equal(okp.numpy()[:, pg, off], k.swapaxes(0,
                                                                          1))
        np.testing.assert_array_equal(ovp.numpy()[:, pg, off], v.swapaxes(0,
                                                                          1))


# ------------------------------------------------------------------ ragged
def _ragged_inputs(T, S, H, KV, D, psz, pps, seed=0):
    """Random pools + a ragged batch layout (tests/test_ragged_kernel.py
    `_setup`): disjoint row spans inside [0, T), kv_lengths include the
    new tokens."""
    rng = np.random.RandomState(seed)
    total = S * pps + 1
    q = rng.randn(T, H, D).astype(np.float32)
    kp = rng.randn(KV, total, psz, D).astype(np.float32)
    vp = rng.randn(KV, total, psz, D).astype(np.float32)
    tab = (1 + rng.permutation(total - 1)[:S * pps]).reshape(S, pps)
    cuts = np.sort(rng.choice(T + 1, S - 1, replace=False)) \
        if S > 1 else np.array([], np.int64)
    starts = np.concatenate([[0], cuts]).astype(np.int32)
    ends = np.concatenate([cuts, [T]]).astype(np.int32)
    nt = (ends - starts).astype(np.int32)
    kvl = np.zeros(S, np.int32)
    for i in range(S):
        kvl[i] = rng.randint(max(int(nt[i]), 1), pps * psz + 1)
    kvl = np.maximum(kvl, nt)
    return [q, kp, vp, starts, nt, kvl, tab.astype(np.int32)]


def _ragged_check(jx, args, jax_kernel=False):
    """Port plain version vs the JAX reference and, with `jax_kernel`,
    the JAX kernel (a few seconds each in interpret mode, so the edge
    cases below hold the port against the reference only); returns the
    port's output."""
    jargs = [jx.jnp.asarray(a) for a in args]
    before = ragged_paged_attention.plain_calls
    got = ragged_paged_attention(*[_t(a) for a in args]).numpy()
    assert ragged_paged_attention.plain_calls == before + 1
    _close(got, jx.ragged_ref(*jargs))
    if jax_kernel:
        _close(got, jx.ragged(*jargs))
    return got


class TestRaggedParity:
    @pytest.mark.parametrize("T,S,H,KV,D,psz,pps,jax_kernel", [
        (12, 3, 8, 2, 128, 16, 4, True),   # GQA rep=4, mixed spans
        (9, 4, 4, 2, 64, 8, 2, True),      # GQA rep=2, odd T
        (20, 2, 4, 4, 32, 8, 4, False),    # MHA rep=1, small pages, D=32
    ])
    def test_matches_jax(self, jx, T, S, H, KV, D, psz, pps, jax_kernel):
        _ragged_check(jx, _ragged_inputs(T, S, H, KV, D, psz, pps),
                      jax_kernel=jax_kernel)

    def test_mixed_prefill_decode_batch(self, jx):
        # the engine's shape: decode rows 0..B-1 (one token each, one
        # idle), a prefill chunk on rows B.., kv_lengths include new rows
        B, C, psz, pps, KV, H, D = 3, 5, 8, 4, 2, 4, 64
        T, S = B + C, B + 1
        args = _ragged_inputs(T, S, H, KV, D, psz, pps, seed=1)
        args[3] = np.asarray(list(range(B)) + [B], np.int32)
        args[4] = np.asarray([1, 0, 1, C], np.int32)
        args[5] = np.asarray([7, 0, 19, 6 + C], np.int32)
        out = _ragged_check(jx, args)
        np.testing.assert_array_equal(out[1], 0.0)

    def test_empty_slots_emit_zeros(self, jx):
        args = _ragged_inputs(10, 3, 4, 2, 128, 16, 2, seed=2)
        args[4][1] = 0
        out = _ragged_check(jx, args)
        covered = np.zeros(10, bool)
        for i in range(3):
            covered[args[3][i]:args[3][i] + args[4][i]] = True
        np.testing.assert_array_equal(out[~covered], 0.0)

    def test_sentinel_table_entries(self, jx):
        # dead tail pages marked -1: clamped, never read past kv_lengths
        args = _ragged_inputs(8, 2, 4, 2, 64, 16, 4, seed=3)
        args[5] = np.minimum(args[5], 16)
        args[6][:, 1:] = -1
        _ragged_check(jx, args)

    def test_single_sequence_whole_buffer(self, jx):
        T = 16
        args = _ragged_inputs(T, 1, 8, 2, 128, 16, 4, seed=4)
        args[3] = np.asarray([0], np.int32)
        args[4] = np.asarray([T], np.int32)
        args[5] = np.asarray([T + 13], np.int32)
        _ragged_check(jx, args)

    def test_causality_within_chunk(self, jx):
        # flipping the last chunk row's K/V leaves earlier rows unchanged
        T, psz = 6, 8
        rng = np.random.RandomState(5)
        q = rng.randn(T, 4, 64).astype(np.float32)
        kp = rng.randn(2, 3, psz, 64).astype(np.float32)
        vp = rng.randn(2, 3, psz, 64).astype(np.float32)
        rows = [np.asarray([0], np.int32), np.asarray([T], np.int32),
                np.asarray([T], np.int32), np.asarray([[1, 2]], np.int32)]
        out1 = _ragged_check(jx, [q, kp, vp] + rows)
        kp2, vp2 = kp.copy(), vp.copy()
        kp2[:, 1, T - 1] = 99.0
        vp2[:, 1, T - 1] = -99.0
        out2 = _ragged_check(jx, [q, kp2, vp2] + rows)
        np.testing.assert_array_equal(out1[:T - 1], out2[:T - 1])


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
class TestKernelsOnCard:
    """Each CUDA kernel against its plain version on the same inputs on
    the card: f32 at 2e-5 (summation order), bf16 at 2e-2 (one bf16
    rounding of outputs of magnitude up to ~4)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are CUDA C++ "
                        "with no CPU mode")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _tol(dtype):
        return TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rms_norm(self, dtype):
        g = torch.Generator("cuda").manual_seed(0)
        x = torch.randn(132, 4096, device="cuda", generator=g).to(dtype)
        w = torch.randn(4096, device="cuda", generator=g).to(dtype)
        n = fused_rms_norm.launches
        got = fused_rms_norm(x, w, 1e-5)
        torch.cuda.synchronize()
        assert fused_rms_norm.launches == n + 1
        torch.testing.assert_close(
            got.float(), ops.rms_norm_reference(x, w, 1e-5).float(),
            **self._tol(dtype))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("T,H,w_dtype", [
        (132, 4096, None), (37, 200, None), (5, 1000, torch.float32)])
    def test_layer_norm(self, dtype, T, H, w_dtype):
        # H 4096: 16-byte pieces; 200 and 1000 rows take element loads in
        # bf16 (200: no whole 16-byte pieces in f32 either); row 1 has a
        # mean of 30 against a spread of 1: a one-pass E[x^2] - E[x]^2
        # loses ~1e-3 of its variance in f32, the two passes keep the
        # output within the f32 bar
        g = torch.Generator("cuda").manual_seed(2)
        x = torch.randn(T, H, device="cuda", generator=g)
        x[1] += 30.0
        x = x.to(dtype)
        wd = w_dtype or dtype
        w = torch.randn(H, device="cuda", generator=g).to(wd)
        b = torch.randn(H, device="cuda", generator=g).to(wd)
        n = fused_layer_norm.launches
        got = fused_layer_norm(x, w, b, 1e-5)
        torch.cuda.synchronize()
        assert fused_layer_norm.launches == n + 1
        assert got.dtype == dtype
        torch.testing.assert_close(
            got.float(), ops.layer_norm_reference(x, w, b, 1e-5).float(),
            **self._tol(dtype))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rope_append(self, dtype):
        g = torch.Generator("cuda").manual_seed(1)
        T, Hq, KV, D, P, psz = 20, 8, 2, 128, 9, 4
        r = lambda *s: torch.randn(*s, device="cuda",    # noqa: E731
                                   generator=g).to(dtype)
        q, k, v = r(T, Hq, D), r(T, KV, D), r(T, KV, D)
        cos = torch.randn(T, D // 2, device="cuda", generator=g)
        sin = torch.randn(T, D // 2, device="cuda", generator=g)
        kp, vp = r(KV, P, psz, D), r(KV, P, psz, D)
        pg = torch.tensor([1, 2, 0, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6,
                           6, 6, 6, 8], device="cuda")
        off = torch.tensor([0, 0, 0, 0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3,
                            0, 1, 2, 3, 0], device="cuda")
        kp2, vp2 = kp.clone(), vp.clone()
        oq, okp, ovp = fused_rope_append(q, k, v, cos, sin, kp, vp, pg, off)
        rq, rkp, rvp = ops.rope_append_reference(q, k, v, cos, sin, kp2,
                                                 vp2, pg, off)
        torch.cuda.synchronize()
        assert okp is kp and ovp is vp
        tol = self._tol(dtype)
        torch.testing.assert_close(oq.float(), rq.float(), **tol)
        torch.testing.assert_close(okp[:, 1:].float(), rkp[:, 1:].float(),
                                   **tol)
        torch.testing.assert_close(ovp[:, 1:], rvp[:, 1:], rtol=0, atol=0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("T,S,H,KV,D,psz,pps", [
        (12, 3, 8, 2, 128, 16, 4), (9, 4, 4, 2, 64, 8, 2),
        (20, 2, 4, 4, 32, 8, 4), (40, 3, 32, 8, 128, 16, 8),
        # GPT-3 6.7B's heads (rep 1) and Qwen2-7B's (rep 7)
        (40, 3, 32, 32, 128, 16, 8), (40, 3, 28, 4, 128, 16, 8)])
    def test_ragged(self, dtype, T, S, H, KV, D, psz, pps):
        args = [_t(a).cuda() for a in _ragged_inputs(T, S, H, KV, D, psz,
                                                      pps, seed=7)]
        args[:3] = [a.to(dtype) for a in args[:3]]
        n = ragged_paged_attention.launches
        got = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        assert ragged_paged_attention.launches == n + 1
        ref = ops.ragged_attention_reference(*args)
        torch.testing.assert_close(got.float(), ref.float(),
                                   **self._tol(dtype))


def _bf16_spacings(got, ref):
    """max |got - ref| in bf16 spacings at ref's magnitude (the spacing of
    the bf16 numbers at or below |ref|), the magnitude floored at 1/256
    of the tensor's largest: an f32 sum taken in another order differs
    relative to its terms, so a value that cancels to near 0 is judged at
    the spacing of the terms' scale."""
    got, ref = got.detach().float(), ref.detach().float()
    mag = ref.abs().clamp_min(max(float(ref.abs().max()) / 256,
                                  torch.finfo(torch.bfloat16).tiny))
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got - ref).abs() / spacing).max().item()


@pytest.mark.cuda
class TestFusedKernelsOnCard:
    """swiglu, fused_rope (forward and its backward launch),
    fused_bias_residual_layer_norm and fused_moe_dispatch_combine against
    their plain versions on the card: f32 at 2e-5; bf16 within one bf16
    spacing (the kernels compute in f32 with one cast, as the plain
    versions do; only the f32 rounding before the cast may differ); the
    MoE outputs exact on 0/1 keep and one-hots."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are CUDA C++ "
                        "with no CPU mode")

    @staticmethod
    def _check(got, ref, dtype):
        assert got.dtype == ref.dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, **TOL)
        else:
            assert _bf16_spacings(got, ref) <= 1.0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,split", [((4096, 14336), False),
                                             ((4096, 14336), True),
                                             ((3, 37, 90), True),
                                             ((37, 45), False)])
    def test_swiglu(self, dtype, shape, split):
        g = torch.Generator("cuda").manual_seed(3)
        if split:
            x = (torch.randn(*shape[:-1], 2 * shape[-1], device="cuda",
                             generator=g) * 3).to(dtype)
            args = (x,)
            ref = ops.swiglu_reference(x)
        else:
            args = tuple((torch.randn(*shape, device="cuda", generator=g)
                          * 3).to(dtype) for _ in range(2))
            ref = ops.swiglu_reference(*args)
        n = ops.swiglu.launches
        got = ops.swiglu(*args)
        torch.cuda.synchronize()
        assert ops.swiglu.launches == n + 1
        self._check(got, ref, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,S_,Hq,Hk,D", [(1, 4096, 32, 8, 128),
                                              (2, 37, 4, 2, 64)])
    def test_rope(self, dtype, B, S_, Hq, Hk, D):
        g = torch.Generator("cuda").manual_seed(4)
        q = torch.randn(B, S_, Hq, D, device="cuda", generator=g).to(dtype)
        k = torch.randn(B, S_, Hk, D, device="cuda", generator=g).to(dtype)
        ang = torch.rand(S_ + 5, D // 2, device="cuda", generator=g) * 6.3
        cos, sin = ang.cos(), ang.sin()
        q.requires_grad_(), k.requires_grad_()
        n, nb = ops.fused_rope.launches, ops.fused_rope_bwd.launches
        qo, ko = ops.fused_rope(q, k, cos, sin)
        gq, gk = torch.randn_like(qo), torch.randn_like(ko)
        dq, dk = torch.autograd.grad((qo, ko), (q, k), (gq, gk))
        torch.cuda.synchronize()
        assert ops.fused_rope.launches == n + 1
        assert ops.fused_rope_bwd.launches == nb + 1
        rq, rk = ops.rope_reference(q.detach(), k.detach(), cos, sin)
        self._check(qo, rq, dtype)
        self._check(ko, rk, dtype)
        from paddle_tpu_torch.ops.fused import _rope_bwd_reference
        rdq, rdk = _rope_bwd_reference(gq, gk, cos, sin)
        self._check(dq, rdq, dtype)
        self._check(dk, rdk, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("T,H,parts", [(4096, 4096, "all"),
                                           (37, 200, "none"),
                                           (5, 1000, "f32_params")])
    def test_bias_residual_layer_norm(self, dtype, T, H, parts):
        g = torch.Generator("cuda").manual_seed(5)
        x = torch.randn(T, H, device="cuda", generator=g)
        x[1] += 30.0      # a large mean: the centred variance keeps it
        x = x.to(dtype)
        r = torch.randn(T, H, device="cuda", generator=g).to(dtype)
        pd = torch.float32 if parts == "f32_params" else dtype
        b, w, lb = (torch.randn(H, device="cuda", generator=g).to(pd)
                    for _ in range(3))
        kw = {} if parts == "none" else dict(bias=b, weight=w, ln_bias=lb)
        n = ops.fused_bias_residual_layer_norm.launches
        got = ops.fused_bias_residual_layer_norm(x, r, eps=1e-5, **kw)
        torch.cuda.synchronize()
        assert ops.fused_bias_residual_layer_norm.launches == n + 1
        ref = ops.bias_residual_layer_norm_reference(x, r, eps=1e-5, **kw)
        self._check(got, ref, dtype)

    @pytest.mark.parametrize("T,K,E,C,dtype", [
        (4096, 6, 64, 480, torch.float32), (33, 2, 8, 6, torch.float32),
        (64, 6, 64, 480, torch.bfloat16), (9, 3, 5, 7, torch.bfloat16)])
    def test_moe_dispatch_combine(self, T, K, E, C, dtype):
        g = torch.Generator("cuda").manual_seed(6)
        ex = torch.stack([torch.randperm(E, device="cuda", generator=g)[:K]
                          for _ in range(T)])
        keep = torch.nn.functional.one_hot(ex, E).to(dtype)
        keep *= (torch.rand(T, K, 1, device="cuda", generator=g) > 0.2)
        loc = torch.randint(0, C, (T, K), device="cuda", generator=g)
        oh = torch.nn.functional.one_hot(loc, C).to(dtype)
        gv = torch.rand(T, K, device="cuda", generator=g).to(dtype)
        n = ops.fused_moe_dispatch_combine.launches
        d, c = ops.fused_moe_dispatch_combine(keep, oh, gv)
        torch.cuda.synchronize()
        assert ops.fused_moe_dispatch_combine.launches == n + 1
        rd, rc = ops.moe_dispatch_combine_reference(keep, oh, gv)
        assert torch.equal(d, rd) and torch.equal(c, rc)
        # real-valued operands: f32 sums over k in order
        if dtype == torch.float32:
            keep2 = torch.randn(T, K, E, device="cuda", generator=g)
            oh2 = torch.randn(T, K, C, device="cuda", generator=g)
            d2, c2 = ops.fused_moe_dispatch_combine(keep2, oh2, gv)
            rd2, rc2 = ops.moe_dispatch_combine_reference(keep2, oh2, gv)
            torch.testing.assert_close(d2, rd2, **TOL)
            torch.testing.assert_close(c2, rc2, **TOL)

    def test_refusals(self):
        x = torch.randn(4, 8, device="cuda", dtype=torch.float16)
        with pytest.raises(TypeError):
            ops.swiglu(x, x)
        keep = torch.zeros(2, 8, 512, device="cuda")
        oh = torch.zeros(2, 8, 2048, device="cuda")
        with pytest.raises(ValueError, match="exceeds"):
            ops.fused_moe_dispatch_combine(keep, oh,
                                           torch.zeros(2, 8, device="cuda"))


@pytest.mark.cuda
class TestGenericElementwiseOnCard:
    """generic_elementwise (B11) against its plain version on the card,
    with operands broadcast (stride 0) and strided (slices of a wider
    tensor) in place: both compute each instruction in f32 and round it
    to the region's dtype, so the results are held bit for bit in f32,
    bf16 and f16."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are CUDA C++ "
                        "with no CPU mode")

    ROPE = [{"op": "multiply", "ins": ["#0", "#1"], "out": "a"},
            {"op": "multiply", "ins": ["#2", "#3"], "out": "b"},
            {"op": "subtract", "ins": ["a", "b"], "out": "c"},
            {"op": "multiply", "ins": ["c", 0.5], "out": "d"}]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
    @pytest.mark.parametrize("B,S_,H,D", [(1, 2048, 32, 128),
                                          (2, 37, 3, 64)])
    def test_broadcast_and_strided_operands(self, dtype, B, S_, H, D):
        g = torch.Generator("cuda").manual_seed(S_ + D)
        x = torch.randn(B, S_, H, D, device="cuda", generator=g).to(dtype)
        cos, sin = (torch.randn(1, S_, 1, D // 2, device="cuda",
                                generator=g).to(dtype) for _ in range(2))
        args = (x[..., :D // 2], cos, x[..., D // 2:], sin)
        n = ops.generic_elementwise.launches
        got = ops.generic_elementwise(self.ROPE, *args)
        torch.cuda.synchronize()
        assert ops.generic_elementwise.launches == n + 1
        want = ops.generic_elementwise_reference(self.ROPE, *args)
        assert got.shape == (B, S_, H, D // 2) and got.is_contiguous()
        assert torch.equal(got, want)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_every_opcode(self, dtype):
        from paddle_tpu_torch.ops.elementwise import EW_OPS, _UNARY
        g = torch.Generator("cuda").manual_seed(11)
        x = (torch.rand(257, 129, device="cuda", generator=g) * 4
             + 0.25).to(dtype)
        y = ((torch.rand(1, 129, device="cuda", generator=g) + 0.25)
             * torch.randn(1, 129, device="cuda", generator=g).sign()
             ).to(dtype)
        for op in EW_OPS:
            prog = [{"op": op, "ins": ["#0"] if op in _UNARY else
                     ["#0", "#1"], "out": "r"},
                    {"op": "multiply", "ins": ["r", "#1"], "out": "s"},
                    {"op": "add", "ins": ["s", 0.75], "out": "t"}]
            got = ops.generic_elementwise(prog, x, y)
            want = ops.generic_elementwise_reference(prog, x, y)
            assert torch.equal(got, want), op

    def test_refusals(self):
        x = torch.ones(4, 4, device="cuda")
        too_many = [{"op": "negate", "ins": ["#0" if i == 0 else f"r{i-1}"],
                     "out": f"r{i}"} for i in range(40)]
        with pytest.raises(ValueError, match="instructions"):
            ops.generic_elementwise(too_many, x)
        with pytest.raises(ValueError, match="tensors on"):
            ops.generic_elementwise([{"op": "add", "ins": ["#0", "#1"],
                                      "out": "r"}], x, torch.ones(4, 4))
