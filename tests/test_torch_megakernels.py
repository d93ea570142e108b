"""The port's three megakernels against the JAX package.

For fused_qkv_rope_append, fused_oproj_norm and fused_ffn (fp weights,
rms norm, swiglu), seeded numpy inputs go through the JAX kernel (Pallas
in interpret mode on the CPU, as tests/test_megafront.py and
tests/test_megadecode.py run it), the JAX reference and the port's
wrapper on CPU tensors, which runs its plain PyTorch version. f32
throughout: the two megadecode kernels at 2e-6 atol/rtol, the JAX tests'
own bar (tests/test_megadecode.py); qkv_rope_append at 2e-5, because rope
multiplies the projection by cos/sin and the two frameworks may fuse its
multiply-adds differently. Pools are compared whole: each case writes
one idle row to the trash page 0 (no duplicate writes) and fills part of
a page whose other slots must keep their old rows.

`TestKernelsOnCard` holds each CUDA kernel against its plain version on
the card; it needs one and skips elsewhere. On the machine with the
card, which has no JAX: python -m pytest --noconftest
tests/test_torch_megakernels.py -m cuda."""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import (fused_ffn, fused_oproj_norm,
                                  fused_qkv_rope_append,
                                  megadecode_eligible, megafront_eligible)


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


class TestRefusalsAndGates:
    @pytest.mark.parametrize("call,item", [
        (lambda t: fused_qkv_rope_append(*t[:10], heads=1, kv_heads=1,
                                         head_dim=4,
                                         algo="weight_only_int8"), 4),
        (lambda t: fused_qkv_rope_append(*t[:10], heads=1, kv_heads=1,
                                         head_dim=4, lora_rank=8), 5),
        (lambda t: fused_oproj_norm(t[0], t[0], t[1],
                                    algo="weight_only_int4"), 4),
        (lambda t: fused_oproj_norm(t[0], t[0], t[1], norm="layer"), 5),
        (lambda t: fused_ffn(t[0], t[0], t[1], None, t[1], None, t[1],
                             act="gelu"), 5),
        (lambda t: fused_ffn(t[0], t[0], t[1], None, t[1], None, t[1],
                             algo="weight_only_int8"), 4),
    ])
    def test_unported_sites_name_their_item(self, call, item):
        t = [torch.zeros(2, 4)] * 2 + [None] * 8
        with pytest.raises(NotImplementedError,
                           match=f"queue A item {item}"):
            call(t)

    def test_gates(self):
        # Llama-3-8B: qkv slab [4096, 6144], head_dim 128; FFN 14336
        assert megafront_eligible(4096, 6144, 128)
        assert megadecode_eligible(4096, 14336, 4096)
        assert megafront_eligible(4096, 6144, 128, dtype_bytes=4)
        # what the kernels cannot take: an odd head_dim, rows that are no
        # whole 16-byte pieces, packed int4
        assert megafront_eligible(4096, 96 * 12, 96)
        assert not megafront_eligible(4096, 8 * 15, 15)
        assert not megafront_eligible(4100, 6144, 128)
        assert not megafront_eligible(4096, 6148, 106)
        assert not megafront_eligible(4096, 6144, 128, int4=True)
        assert not megadecode_eligible(4096, 14330, 4096)
        assert not megadecode_eligible(4096, 14336, 4096, int4=True)
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

    def test_refuses_what_it_cannot_take(self):
        x = torch.zeros(4, 12, device="cuda")
        with pytest.raises(ValueError, match="multiples of 8"):
            fused_oproj_norm(x, x, torch.zeros(12, 12, device="cuda"))
