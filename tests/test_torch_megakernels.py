"""The port's three megakernels against the JAX package.

For fused_qkv_rope_append, fused_oproj_norm and fused_ffn (rms norm,
swiglu; fp weights, and in `TestQuantizedSitesParity` the int8 and
packed-int4 deploy layouts; the layer-norm and gelu sites of the gpt
family are held to JAX in test_torch_gpt.py), seeded numpy inputs go
through the JAX kernel (Pallas
in interpret mode on the CPU, as tests/test_megafront.py and
tests/test_megadecode.py run it), the JAX reference and the port's
wrapper on CPU tensors, which runs its plain PyTorch version. f32
throughout: the two megadecode kernels at 2e-6 atol/rtol, the JAX tests'
own bar (tests/test_megadecode.py); qkv_rope_append at 2e-5, because rope
multiplies the projection by cos/sin and the two frameworks may fuse its
multiply-adds differently. Pools are compared whole: each case writes
one idle row to the trash page 0 (no duplicate writes) and fills part of
a page whose other slots must keep their old rows. Quantized sites are
held to the JAX kernels (the same op order: int8 ``h @ (q * s)``, int4
the even / odd split contraction) at the same bars, and to the JAX
references (one product over the whole dequantized weight) at the JAX
tests' own bars for int4's split contraction (tests/test_megadecode.py
atol 1e-4, rtol 1e-5; qkv 2e-5 as above).

`TestKernelsOnCard` holds each CUDA kernel against its plain version on
the card; it needs one and skips elsewhere. On the machine with the
card, which has no JAX: python -m pytest --noconftest
tests/test_torch_megakernels.py -m cuda. Its bf16 int8 / int4 cases, and
the bf16 fp FFN (swiglu and gelu), are also held by relative errors over
each site's outputs and over each token's row of them (`_site_rows`),
within chip_smoke.py's QSITE_BF16_LIMITS, which sit between the sound
kernels' readings and those of a scale folded into the bf16 weight
(quant_limits.py). The layer-norm site of fused_oproj_norm and the gelu
site of fused_ffn are held the same way as their rms / swiglu
siblings."""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import (fused_ffn, fused_oproj_norm,
                                  fused_qkv_rope_append,
                                  megadecode_eligible, megafront_eligible,
                                  weight_quantize)

INT8, INT4 = "weight_only_int8", "weight_only_int4"
#: (tensor, row) relative-error limits of the bf16 quantized sites and
#: of the bf16 FFN, chip_smoke.py's: every site's sound kernel rounds only
#: its outputs (the FFN feeds its f32 activation to the down product as
#: bf16 hi + lo planes); a scale folded into the bf16 weight reads 2.6e-3
#: and more over the tensor
QSITE_BF16_LIMITS = {"qkv": (3e-4, 1e-3), "oproj": (3e-4, 1e-3),
                     "ffn": (3e-4, 1e-3)}


def _site_rows(outs, pg=None, off=None):
    """One [T, X] tensor of a site's outputs, a row per token: for
    qkv_rope_append (pg / off given) q and the K / V rows written into
    the pools, else the outputs side by side."""
    if pg is None:
        return torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)
    q, kp, vp = outs
    T = q.shape[0]
    return torch.cat([q.reshape(T, -1)] + [
        p[:, pg.long(), off.long()].transpose(0, 1).reshape(T, -1)
        for p in (kp, vp)], dim=1)


def _hold_rel(site, got, want):
    """`got` [T, X] within QSITE_BF16_LIMITS[site] of `want`: ||got -
    want|| / ||want|| over the whole, and over each row (its norm floored
    at 1% of the root-mean-square row norm)."""
    w = want.float()
    d = got.float() - w
    wn, dn = w.norm(dim=-1), d.norm(dim=-1)
    floor = 1e-2 * float(w.norm()) / wn.numel() ** 0.5
    tensor = float(d.norm() / w.norm())
    row = float((dn / wn.clamp_min(floor)).max())
    lt, lr = QSITE_BF16_LIMITS[site]
    assert tensor <= lt, (site, "tensor", tensor)
    assert row <= lr, (site, "row", row)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only class runs on a
    machine without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.ops import pallas_megadecode, pallas_megafront, \
        references
    return types.SimpleNamespace(
        jnp=jnp, qkv=pallas_megafront.fused_qkv_rope_append,
        qkv_ref=references.qkv_rope_append_reference,
        oproj=pallas_megadecode.fused_oproj_norm,
        oproj_ref=references.oproj_norm_reference,
        ffn=pallas_megadecode.fused_ffn,
        ffn_ref=references.megadecode_ffn_reference)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, tol, *refs):
    for ref in refs:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(ref, np.float32), atol=tol,
                                   rtol=tol)


def _pages(T, psz=4):
    """A serving step's page walk over T rows: row 0 idle on the trash
    page 0; the rest on pages 2.. in order, starting at offset 1 of
    page 2, so page 2's slot 0 keeps its old row. Rows that share a page
    are adjacent, as the JAX kernel's page walk requires."""
    pg, off = [], []
    pos = 1
    for t in range(T):
        if t == 0:
            pg.append(0)
            off.append(0)
            continue
        pg.append(2 + pos // psz)
        off.append(pos % psz)
        pos += 1
    return np.asarray(pg, np.int32), np.asarray(off, np.int32)


def _qkv_inputs(T, H, heads, kv, D, bias, psz=4, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    N = (heads + 2 * kv) * D
    total = 3 + T // psz
    pg, off = _pages(T, psz)
    return dict(h=f(T, H), w=f(H, N) * H ** -0.5, b=f(N) if bias else None,
                cos=f(T, D // 2), sin=f(T, D // 2),
                kp=f(kv, total, psz, D), vp=f(kv, total, psz, D), pg=pg,
                off=off)


class TestQkvRopeAppendParity:
    @pytest.mark.parametrize("T,H,heads,kv,D,bias", [
        (7, 40, 3, 1, 12, False),      # H, N not multiples of 128
        (12, 72, 4, 2, 16, True),      # GQA, qkv bias
    ])
    def test_matches_jax(self, jx, T, H, heads, kv, D, bias):
        a = _qkv_inputs(T, H, heads, kv, D, bias)
        kw = dict(heads=heads, kv_heads=kv, head_dim=D)
        j = lambda v: None if v is None else jx.jnp.asarray(v)  # noqa: E731
        jargs = [j(a[k]) for k in ("h", "w")] + [None, j(a["b"])] + \
            [j(a[k]) for k in ("cos", "sin", "kp", "vp", "pg", "off")]
        want = [jx.qkv(*jargs, **kw), jx.qkv_ref(*jargs, **kw)]
        kp, vp = _t(a["kp"]), _t(a["vp"])
        before = fused_qkv_rope_append.plain_calls
        q, okp, ovp = fused_qkv_rope_append(
            _t(a["h"]), _t(a["w"]), None, _t(a["b"]), _t(a["cos"]),
            _t(a["sin"]), kp, vp, _t(a["pg"]).long(), _t(a["off"]), **kw)
        assert fused_qkv_rope_append.plain_calls == before + 1
        assert okp is kp and ovp is vp      # in place, same tensors
        assert tuple(q.shape) == (T, heads, D)
        for i, got in enumerate((q, okp, ovp)):
            _close(got.numpy(), 2e-5, *(w[i] for w in want))
        # page 2's slot 0 kept its old row; the idle row reached page 0
        np.testing.assert_array_equal(okp.numpy()[:, 2, 0], a["kp"][:, 2, 0])
        assert not np.array_equal(okp.numpy()[:, 0, 0], a["kp"][:, 0, 0])

    def test_bias_none_is_zeros(self):
        a = _qkv_inputs(5, 16, 2, 1, 8, False, seed=1)
        kw = dict(heads=2, kv_heads=1, head_dim=8)
        outs = [fused_qkv_rope_append(
            _t(a["h"]), _t(a["w"]), None, b, _t(a["cos"]), _t(a["sin"]),
            _t(a["kp"]), _t(a["vp"]), _t(a["pg"]), _t(a["off"]), **kw)
            for b in (None, torch.zeros(32))]
        for x, y in zip(*outs):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


class TestOprojNormParity:
    @pytest.mark.parametrize("T,Ko,H,bias", [(7, 48, 40, False),
                                             (12, 136, 24, True)])
    def test_matches_jax(self, jx, T, Ko, H, bias):
        rng = np.random.RandomState(2)
        o, x = _rand(rng, T, Ko), _rand(rng, T, H)
        w, nw = _rand(rng, Ko, H, scale=Ko ** -0.5), _rand(rng, H)
        b = _rand(rng, H) if bias else None
        o[3] = 0.0                      # an idle row: zero attention output
        x[3] = 0.0
        jj = [jx.jnp.asarray(v) for v in (o, x, w)]
        jb = None if b is None else jx.jnp.asarray(b)
        jkw = dict(bias=jb, norm_weight=jx.jnp.asarray(nw), eps=1e-5)
        want = [jx.oproj(*jj, **jkw), jx.oproj_ref(*jj, **jkw)]
        before = fused_oproj_norm.plain_calls
        xn, h = fused_oproj_norm(_t(o), _t(x), _t(w), None, _t(b), _t(nw),
                                 eps=1e-5)
        assert fused_oproj_norm.plain_calls == before + 1
        assert np.isfinite(h.numpy()).all()
        for i, got in enumerate((xn, h)):
            _close(got.numpy(), 2e-6, *(w_[i] for w_ in want))

    def test_batched_shape(self):
        rng = np.random.RandomState(3)
        o, x = _t(_rand(rng, 1, 5, 16)), _t(_rand(rng, 1, 5, 8))
        xn, h = fused_oproj_norm(o, x, _t(_rand(rng, 16, 8)))
        assert xn.shape == x.shape and h.shape == x.shape


class TestFfnParity:
    @pytest.mark.parametrize("T,H,I,bias", [(7, 40, 72, False),
                                            (12, 24, 136, True)])
    def test_matches_jax(self, jx, T, H, I, bias):
        rng = np.random.RandomState(4)
        h, x = _rand(rng, T, H), _rand(rng, T, H)
        wg, wu = _rand(rng, H, I, scale=H ** -0.5), \
            _rand(rng, H, I, scale=H ** -0.5)
        wd = _rand(rng, I, H, scale=I ** -0.5)
        b1, b2 = (_rand(rng, I), _rand(rng, H)) if bias else (None, None)
        j = lambda v: None if v is None else jx.jnp.asarray(v)  # noqa: E731
        jargs = (j(h), j(x), j(wg), None, j(wu), None, j(wd), None, j(b1),
                 j(b2))
        want = [jx.ffn(*jargs), jx.ffn_ref(*jargs)]
        before = fused_ffn.plain_calls
        got = fused_ffn(_t(h), _t(x), _t(wg), None, _t(wu), None, _t(wd),
                        None, _t(b1), _t(b2))
        assert fused_ffn.plain_calls == before + 1
        _close(got.numpy(), 2e-6, *want)


def _quantized(w, algo):
    """(payload, f32 scale) numpy of a seeded f32 weight's deploy layout."""
    q, s = weight_quantize(torch.from_numpy(w), algo)
    return q.numpy(), s.numpy()


class TestQuantizedSitesParity:
    """The int8 and packed-int4 sites: the plain versions against the JAX
    kernels and references (module docstring for the bars)."""

    @staticmethod
    def _ref_tol(algo, fp_tol):
        return (1e-4, 1e-5) if algo == INT4 and fp_tol < 2e-5 \
            else (fp_tol, fp_tol)

    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("T,H,heads,kv,D,bias", [
        (7, 40, 3, 1, 12, False), (12, 72, 4, 2, 16, True)])
    def test_qkv_rope_append(self, jx, algo, T, H, heads, kv, D, bias):
        a = _qkv_inputs(T, H, heads, kv, D, bias, seed=8)
        qw, s = _quantized(a["w"], algo)
        kw = dict(heads=heads, kv_heads=kv, head_dim=D, algo=algo)
        j = lambda v: None if v is None else jx.jnp.asarray(v)  # noqa: E731
        jargs = [j(a["h"]), j(qw), j(s), j(a["b"])] + \
            [j(a[k]) for k in ("cos", "sin", "kp", "vp", "pg", "off")]
        want_k = jx.qkv(*jargs, **kw)
        want_r = jx.qkv_ref(*jargs, **kw)
        before = fused_qkv_rope_append.plain_calls
        got = fused_qkv_rope_append(
            _t(a["h"]), _t(qw), _t(s), _t(a["b"]), _t(a["cos"]),
            _t(a["sin"]), _t(a["kp"]), _t(a["vp"]), _t(a["pg"]),
            _t(a["off"]), **kw)
        assert fused_qkv_rope_append.plain_calls == before + 1
        for i, g in enumerate(got):
            _close(g.numpy(), 2e-5, want_k[i], want_r[i])

    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("T,Ko,H,bias", [(7, 48, 40, False),
                                             (12, 136, 24, True)])
    def test_oproj_norm(self, jx, algo, T, Ko, H, bias):
        rng = np.random.RandomState(9)
        o, x, nw = _rand(rng, T, Ko), _rand(rng, T, H), _rand(rng, H)
        qw, s = _quantized(_rand(rng, Ko, H, scale=Ko ** -0.5), algo)
        b = _rand(rng, H) if bias else None
        jj = [jx.jnp.asarray(v) for v in (o, x, qw, s)]
        jkw = dict(bias=None if b is None else jx.jnp.asarray(b),
                   norm_weight=jx.jnp.asarray(nw), eps=1e-5, algo=algo)
        want_k, want_r = jx.oproj(*jj, **jkw), jx.oproj_ref(*jj, **jkw)
        before = fused_oproj_norm.plain_calls
        got = fused_oproj_norm(_t(o), _t(x), _t(qw), _t(s), _t(b), _t(nw),
                               eps=1e-5, algo=algo)
        assert fused_oproj_norm.plain_calls == before + 1
        atol, rtol = self._ref_tol(algo, 2e-6)
        for i, g in enumerate(got):
            _close(g.numpy(), 2e-6, want_k[i])
            np.testing.assert_allclose(g.numpy(), np.asarray(want_r[i]),
                                       atol=atol, rtol=rtol)

    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("T,H,I,bias", [(7, 40, 72, False),
                                            (12, 24, 136, True)])
    def test_ffn(self, jx, algo, T, H, I, bias):
        rng = np.random.RandomState(10)
        h, x = _rand(rng, T, H), _rand(rng, T, H)
        (qg, sg), (qu, su) = (_quantized(_rand(rng, H, I, scale=H ** -0.5),
                                         algo) for _ in range(2))
        qd, sd = _quantized(_rand(rng, I, H, scale=I ** -0.5), algo)
        b1, b2 = (_rand(rng, I), _rand(rng, H)) if bias else (None, None)
        args = (h, x, qg, sg, qu, su, qd, sd, b1, b2)
        j = lambda v: None if v is None else jx.jnp.asarray(v)  # noqa: E731
        want_k = jx.ffn(*map(j, args), algo=algo)
        want_r = jx.ffn_ref(*map(j, args), algo=algo)
        before = fused_ffn.plain_calls
        got = fused_ffn(*map(_t, args), algo=algo)
        assert fused_ffn.plain_calls == before + 1
        _close(got.numpy(), 2e-6, want_k)
        atol, rtol = self._ref_tol(algo, 2e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_r),
                                   atol=atol, rtol=rtol)

    @pytest.mark.parametrize("call", [
        # the sites that named queue A item 4 (quantized) or 5 (the gpt
        # family's layer norm and gelu) before they were ported: each now
        # runs its plain version on CPU tensors
        lambda t, q: fused_qkv_rope_append(
            t[0], q[INT8][0], q[INT8][1], None, t[3], t[3], t[4], t[4],
            t[5], t[5], heads=1, kv_heads=1, head_dim=4, algo=INT8),
        lambda t, q: fused_oproj_norm(t[1], t[1], q[INT4][2], q[INT4][3],
                                      algo=INT4),
        lambda t, q: fused_ffn(t[1], t[1], q[INT8][2], q[INT8][3],
                               q[INT8][2], q[INT8][3], q[INT8][2],
                               q[INT8][3], algo=INT8),
        lambda t, q: fused_oproj_norm(t[1], t[1], t[1][:, :4].T.contiguous()
                                      @ t[1], norm="layer"),
        lambda t, q: fused_ffn(t[1], t[1], q[INT8][2], q[INT8][3], None,
                               None, q[INT8][2], q[INT8][3], act="gelu",
                               algo=INT8),
    ])
    def test_formerly_refused_sites_run(self, call):
        rng = np.random.RandomState(11)
        t = [_t(_rand(rng, 2, 4)), _t(_rand(rng, 2, 4)), None,
             _t(_rand(rng, 2, 2)), _t(_rand(rng, 1, 3, 4, 4)),
             torch.tensor([1, 2])]
        q = {a: [*map(_t, _quantized(_rand(rng, 4, 12), a)),
                 *map(_t, _quantized(_rand(rng, 4, 4), a))]
             for a in (INT8, INT4)}
        out = call(t, q)
        out = out if isinstance(out, tuple) else (out,)
        assert all(bool(torch.isfinite(o).all()) for o in out)


class TestRefusalsAndGates:
    @pytest.mark.parametrize("call,match", [
        (lambda t: fused_qkv_rope_append(*t[:10], heads=1, kv_heads=1,
                                         head_dim=4, lora_rank=8),
         "queue A item 5"),
        # the JAX package refuses int4 gelu too
        (lambda t: fused_ffn(t[0], t[0], t[1], None, t[1], None, t[1],
                             act="gelu", algo=INT4), "swiglu-only"),
    ])
    def test_unported_sites_name_their_item(self, call, match):
        t = [torch.zeros(2, 4)] * 2 + [None] * 8
        with pytest.raises(NotImplementedError, match=match):
            call(t)

    @pytest.mark.parametrize("call", [
        lambda t: fused_oproj_norm(t[0], t[0], t[1], norm="group"),
        lambda t: fused_ffn(t[0], t[0], t[1], None, t[1], None, t[1],
                            act="relu")])
    def test_unknown_norm_or_activation_raises(self, call):
        t = [torch.zeros(2, 4), torch.zeros(4, 4)]
        with pytest.raises(ValueError, match="expected"):
            call(t)

    def test_gates(self):
        # Llama-3-8B: qkv slab [4096, 6144], head_dim 128; FFN 14336
        assert megafront_eligible(4096, 6144, 128)
        assert megadecode_eligible(4096, 14336, 4096)
        assert megafront_eligible(4096, 6144, 128, dtype_bytes=4)
        # what the kernels cannot take: an odd head_dim, rows that are no
        # whole 16-byte pieces
        assert megafront_eligible(4096, 96 * 12, 96)
        assert not megafront_eligible(4096, 8 * 15, 15)
        assert not megafront_eligible(4100, 6144, 128)
        assert not megafront_eligible(4096, 6148, 106)
        assert not megadecode_eligible(4096, 14330, 4096)
        # GPT-3 6.7B (MHA qkv slab [4096, 12288], FFN 16384) and Qwen2-7B
        # (H 3584, 28 / 4 heads x 128, FFN 18944)
        assert megafront_eligible(4096, 3 * 32 * 128, 128)
        assert megadecode_eligible(4096, 16384, 4096)
        assert megafront_eligible(3584, (28 + 2 * 4) * 128, 128)
        assert megadecode_eligible(3584, 18944, 28 * 128)
        # the plain versions take any geometry
        assert megafront_eligible(40, 60, 12, device="cpu")
        assert megadecode_eligible(40, 70, 12, device="cpu")

    def test_registry_holds_the_plain_versions(self):
        reg = ops.oracles()
        assert reg["fused_qkv_rope_append"].reference is \
            ops.qkv_rope_append_reference
        assert reg["fused_oproj_norm"].reference is ops.oproj_norm_reference
        assert reg["fused_ffn"].reference is ops.megadecode_ffn_reference


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
class TestKernelsOnCard:
    """Each CUDA kernel against its plain version on the same inputs on
    the card: f32 at 2e-5 (summation order), bf16 at 2e-2 (one bf16
    rounding of outputs of magnitude up to ~4). T = 132 is the 8B
    serving step's row count (one 160-row tile); 37 is no multiple of 16
    (one tile, mostly masked); 200 takes two 160-row tiles."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are CUDA C++ "
                        "with no CPU mode")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _tol(dtype):
        return dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 \
            else dict(atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("T,H,heads,kv,D,bias", [
        (132, 512, 4, 2, 128, False), (37, 264, 3, 1, 64, True),
        (20, 64, 2, 2, 32, False)])
    def test_qkv_rope_append(self, dtype, T, H, heads, kv, D, bias):
        a = _qkv_inputs(T, H, heads, kv, D, bias, psz=16, seed=5)
        c = {k: (None if v is None else _t(v).cuda()) for k, v in a.items()}
        for k in ("h", "w", "kp", "vp"):
            c[k] = c[k].to(dtype)
        kw = dict(heads=heads, kv_heads=kv, head_dim=D)
        kp2, vp2 = c["kp"].clone(), c["vp"].clone()
        n = fused_qkv_rope_append.launches
        q, kp, vp = fused_qkv_rope_append(
            c["h"], c["w"], None, c["b"], c["cos"], c["sin"], c["kp"],
            c["vp"], c["pg"], c["off"], **kw)
        torch.cuda.synchronize()
        assert fused_qkv_rope_append.launches == n + 1
        assert kp is c["kp"] and vp is c["vp"]
        rq, rkp, rvp = ops.qkv_rope_append_reference(
            c["h"], c["w"], None, c["b"], c["cos"], c["sin"], kp2, vp2,
            c["pg"], c["off"], **kw)
        for got, ref in ((q, rq), (kp, rkp), (vp, rvp)):
            torch.testing.assert_close(got.float(), ref.float(),
                                       **self._tol(dtype))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("T,Ko,H,bias", [(132, 512, 264, False),
                                             (37, 136, 512, True),
                                             (200, 264, 136, False)])
    def test_oproj_norm(self, dtype, T, Ko, H, bias):
        g = torch.Generator("cuda").manual_seed(6)
        r = lambda *s, sc=1.0: (torch.randn(  # noqa: E731
            *s, device="cuda", generator=g) * sc).to(dtype)
        o, x, w, nw = r(T, Ko), r(T, H), r(Ko, H, sc=Ko ** -0.5), r(H)
        b = r(H) if bias else None
        n = fused_oproj_norm.launches
        got = fused_oproj_norm(o, x, w, None, b, nw, eps=1e-5)
        torch.cuda.synchronize()
        assert fused_oproj_norm.launches == n + 1
        ref = ops.oproj_norm_reference(o, x, w, None, b, nw, eps=1e-5)
        for a_, b_ in zip(got, ref):
            torch.testing.assert_close(a_.float(), b_.float(),
                                       **self._tol(dtype))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("T,H,I,bias", [(132, 256, 712, False),
                                            (37, 264, 136, True)])
    def test_ffn(self, dtype, T, H, I, bias):
        g = torch.Generator("cuda").manual_seed(7)
        r = lambda *s, sc=1.0: (torch.randn(  # noqa: E731
            *s, device="cuda", generator=g) * sc).to(dtype)
        h, x = r(T, H), r(T, H)
        wg, wu, wd = r(H, I, sc=H ** -0.5), r(H, I, sc=H ** -0.5), \
            r(I, H, sc=I ** -0.5)
        b1, b2 = (r(I), r(H)) if bias else (None, None)
        n = fused_ffn.launches
        got = fused_ffn(h, x, wg, None, wu, None, wd, None, b1, b2)
        torch.cuda.synchronize()
        assert fused_ffn.launches == n + 1
        ref = ops.megadecode_ffn_reference(h, x, wg, None, wu, None, wd,
                                           None, b1, b2)
        torch.testing.assert_close(got.float(), ref.float(),
                                   **self._tol(dtype))
        if dtype == torch.bfloat16:
            _hold_rel("ffn", got, ref)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("algo", [None, INT8, INT4])
    @pytest.mark.parametrize("T,Ko,H", [(132, 512, 264), (37, 136, 512)])
    def test_oproj_layer_norm(self, dtype, algo, T, Ko, H):
        # the gpt family's site: o-proj bias, layer norm with its bias; the
        # residual stream carries a mean of 30 (two-pass variance)
        g = torch.Generator("cuda").manual_seed(15)
        r = lambda *s, sc=1.0: (torch.randn(  # noqa: E731
            *s, device="cuda", generator=g) * sc).to(dtype)
        o, x, b, nw, nb = r(T, Ko), r(T, H), r(H), r(H), r(H)
        x = (x.float() + 30.0).to(dtype)
        w = r(Ko, H, sc=Ko ** -0.5)
        s = None
        if algo is not None:
            w, s = weight_quantize(w.float(), algo)
        n = fused_oproj_norm.launches
        got = fused_oproj_norm(o, x, w, s, b, nw, nb, eps=1e-5,
                               norm="layer", algo=algo)
        torch.cuda.synchronize()
        assert fused_oproj_norm.launches == n + 1
        ref = ops.oproj_norm_reference(o, x, w, s, b, nw, nb, eps=1e-5,
                                       norm="layer", algo=algo)
        for a_, b_ in zip(got, ref):
            torch.testing.assert_close(a_.float(), b_.float(),
                                       **self._tol(dtype))
        if dtype == torch.bfloat16:
            _hold_rel("oproj", _site_rows(got), _site_rows(ref))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("algo", [None, INT8])
    @pytest.mark.parametrize("T,H,I", [(132, 256, 1024), (37, 264, 136)])
    def test_ffn_gelu(self, dtype, algo, T, H, I):
        # the gpt family's site: one up matrix, b1 before tanh-GELU, b2
        # after the down product; wu is not read
        g = torch.Generator("cuda").manual_seed(16)
        r = lambda *s, sc=1.0: (torch.randn(  # noqa: E731
            *s, device="cuda", generator=g) * sc).to(dtype)
        h, x, b1, b2 = r(T, H), r(T, H), r(I), r(H)
        wi, wf = r(H, I, sc=H ** -0.5), r(I, H, sc=I ** -0.5)
        si = sf = None
        if algo is not None:
            (wi, si), (wf, sf) = (weight_quantize(w_.float(), algo)
                                  for w_ in (wi, wf))
        n = fused_ffn.launches
        got = fused_ffn(h, x, wi, si, None, None, wf, sf, b1, b2,
                        act="gelu", algo=algo)
        torch.cuda.synchronize()
        assert fused_ffn.launches == n + 1
        ref = ops.megadecode_ffn_reference(h, x, wi, si, None, None, wf, sf,
                                           b1, b2, act="gelu", algo=algo)
        torch.testing.assert_close(got.float(), ref.float(),
                                   **self._tol(dtype))
        if dtype == torch.bfloat16:
            _hold_rel("ffn", got, ref)

    def test_int4_gelu_raises_on_the_card(self):
        x = torch.zeros(4, 16, device="cuda", dtype=torch.bfloat16)
        q = torch.zeros(8, 16, device="cuda", dtype=torch.int8)
        s = torch.ones(16, device="cuda")
        with pytest.raises(NotImplementedError, match="swiglu-only"):
            fused_ffn(x, x, q, s, None, None, q, s, act="gelu", algo=INT4)

    def test_refuses_what_it_cannot_take(self):
        x = torch.zeros(4, 12, device="cuda")
        with pytest.raises(ValueError, match="multiples of 8"):
            fused_oproj_norm(x, x, torch.zeros(12, 12, device="cuda"))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("T,H,heads,kv,D", [
        (132, 512, 4, 2, 128), (37, 264, 3, 1, 24)])   # N 120: byte copies
    def test_qkv_rope_append_quantized(self, dtype, algo, T, H, heads, kv,
                                       D):
        a = _qkv_inputs(T, H, heads, kv, D, False, psz=16, seed=12)
        qw, s = (_t(v).cuda() for v in _quantized(a["w"], algo))
        c = {k: (None if v is None else _t(v).cuda()) for k, v in a.items()}
        for k in ("h", "kp", "vp"):
            c[k] = c[k].to(dtype)
        kw = dict(heads=heads, kv_heads=kv, head_dim=D, algo=algo)
        kp2, vp2 = c["kp"].clone(), c["vp"].clone()
        n = fused_qkv_rope_append.launches
        got = fused_qkv_rope_append(c["h"], qw, s, None, c["cos"], c["sin"],
                                    c["kp"], c["vp"], c["pg"], c["off"], **kw)
        torch.cuda.synchronize()
        assert fused_qkv_rope_append.launches == n + 1
        ref = ops.qkv_rope_append_reference(
            c["h"], qw, s, None, c["cos"], c["sin"], kp2, vp2, c["pg"],
            c["off"], **kw)
        for g_, r_ in zip(got, ref):
            torch.testing.assert_close(g_.float(), r_.float(),
                                       **self._tol(dtype))
        if dtype == torch.bfloat16:
            _hold_rel("qkv", _site_rows(got, c["pg"], c["off"]),
                      _site_rows(ref, c["pg"], c["off"]))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("T,Ko,H", [(132, 512, 264), (37, 136, 512),
                                        (200, 264, 136)])
    def test_oproj_norm_quantized(self, dtype, algo, T, Ko, H):
        rng = np.random.RandomState(13)
        o, x, nw = (_t(_rand(rng, *s_)).cuda().to(dtype)
                    for s_ in ((T, Ko), (T, H), (H,)))
        qw, s = (_t(v).cuda() for v in _quantized(
            _rand(rng, Ko, H, scale=Ko ** -0.5), algo))
        n = fused_oproj_norm.launches
        got = fused_oproj_norm(o, x, qw, s, None, nw, eps=1e-5, algo=algo)
        torch.cuda.synchronize()
        assert fused_oproj_norm.launches == n + 1
        ref = ops.oproj_norm_reference(o, x, qw, s, None, nw, eps=1e-5,
                                       algo=algo)
        for a_, b_ in zip(got, ref):
            torch.testing.assert_close(a_.float(), b_.float(),
                                       **self._tol(dtype))
        if dtype == torch.bfloat16:
            _hold_rel("oproj", _site_rows(got), _site_rows(ref))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("algo", [INT8, INT4])
    @pytest.mark.parametrize("T,H,I", [(132, 256, 712), (37, 264, 136)])
    def test_ffn_quantized(self, dtype, algo, T, H, I):
        rng = np.random.RandomState(14)
        h, x = (_t(_rand(rng, T, H)).cuda().to(dtype) for _ in range(2))
        ws = [_quantized(_rand(rng, k, n, scale=k ** -0.5), algo)
              for k, n in ((H, I), (H, I), (I, H))]
        args = [_t(v).cuda() for pair in ws for v in pair]
        n = fused_ffn.launches
        got = fused_ffn(h, x, *args, algo=algo)
        torch.cuda.synchronize()
        assert fused_ffn.launches == n + 1
        ref = ops.megadecode_ffn_reference(h, x, *args, algo=algo)
        torch.testing.assert_close(got.float(), ref.float(),
                                   **self._tol(dtype))
        if dtype == torch.bfloat16:
            _hold_rel("ffn", got, ref)
