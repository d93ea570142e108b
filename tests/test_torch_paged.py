"""The port's paged decode kernels and their routing against the JAX
package.

Seeded numpy inputs go through the JAX kernels (ops/pallas_paged.py,
Pallas in interpret mode on the CPU, as tests/test_paged_kernel.py runs
them), the JAX reference `paged_attention_reference`, and the port's
wrappers on CPU tensors, which run their plain version. f32 at 2e-5
atol/rtol, the bar of tests/test_paged_kernel.py. A length-0 row is zero
in the JAX kernels and in the port (the JAX reference gives the mean of V
there, so it is compared on the other rows only).

`TestPagedKernelsOnCard` holds both CUDA kernels against their plain
version on the card; it needs one and skips elsewhere. On the machine
with the card, which has no JAX: python -m pytest --noconftest
tests/test_torch_paged.py -m cuda."""

import functools
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import flags, ops
from paddle_tpu_torch.ops import paged
from paddle_tpu_torch.ops import paged_attention as routes
from paddle_tpu_torch.ops.paged import (paged_decode_attention,
                                        paged_decode_attention_v2)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only class runs on a
    machine without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from paddle_tpu.ops import flash_attention, paged_attention, pallas_paged
    with jax.default_matmul_precision("highest"):
        yield types.SimpleNamespace(
            jax=jax, jnp=jnp, v1=pallas_paged.paged_decode_attention,
            v2=pallas_paged.paged_decode_attention_v2,
            ref=paged_attention.paged_attention_reference,
            append=paged_attention.append_to_cache,
            sdpa_prefill=flash_attention.sdpa_prefill)


def _inputs(B, H, KV, D, psz, pps, seed=0, lens=None):
    """Random pools (page 0 is trash, never in a table), a permuted page
    table and lengths in [1, pps * psz]."""
    rng = np.random.RandomState(seed)
    total = B * pps + 1
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(KV, total, psz, D).astype(np.float32)
    vp = rng.randn(KV, total, psz, D).astype(np.float32)
    tab = (1 + rng.permutation(total - 1)).reshape(B, pps).astype(np.int32)
    if lens is None:
        lens = rng.randint(1, pps * psz + 1, B)
    return [q, kp, vp, np.asarray(lens, np.int32), tab]


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(fn, args, **kw):
    before = fn.plain_calls
    out = fn(*[_t(a) for a in args], **kw).numpy()
    assert fn.plain_calls == before + 1
    return out


def _jax(jx, fn, args, **kw):
    """A JAX function (its keywords static) on the numpy inputs, jitted:
    one compile instead of op-by-op dispatch."""
    run = jx.jax.jit(functools.partial(fn, **kw))
    return np.asarray(run(*[jx.jnp.asarray(a) for a in args]))


SHAPES = {                       # B, H, KV, D, psz, pps
    "gqa4_d128_psz16": (2, 8, 2, 128, 16, 5),
    "gqa2_d64_psz4": (2, 4, 2, 64, 4, 6),
    "mha_d64_psz16": (2, 4, 4, 64, 16, 4),
}


class TestPagedV1Parity:
    @pytest.mark.parametrize("name", sorted(SHAPES))
    def test_matches_jax_kernel_and_reference(self, jx, name):
        args = _inputs(*SHAPES[name])
        got = _port(paged_decode_attention, args)
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args), **TOL)
        np.testing.assert_allclose(got, _jax(jx, jx.v1, args), **TOL)

    def test_lengths_one_and_full_with_custom_scale(self, jx):
        args = _inputs(2, 8, 2, 128, 16, 4, seed=3, lens=[1, 64])
        got = _port(paged_decode_attention, args, scale=0.05)
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args, scale=0.05),
                                   **TOL)
        np.testing.assert_allclose(got, _jax(jx, jx.v1, args, scale=0.05),
                                   **TOL)

    def test_sentinel_entries_past_the_live_pages(self, jx):
        # pages past a sequence's length marked -1: clamped, never read
        args = _inputs(3, 4, 2, 64, 4, 6, seed=4, lens=[5, 9, 24])
        args[4][0, 2:] = -1
        args[4][1, 3:] = -1
        got = _port(paged_decode_attention, args)
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args), **TOL)
        np.testing.assert_allclose(got, _jax(jx, jx.v1, args), **TOL)

    def test_length_zero_row_is_zero_like_the_jax_kernels(self, jx):
        args = _inputs(2, 4, 1, 128, 16, 4, seed=5, lens=[0, 64])
        got = _port(paged_decode_attention, args)
        v2 = _port(paged_decode_attention_v2, args, pages_per_group=2)
        j1 = _jax(jx, jx.v1, args)
        j2 = _jax(jx, jx.v2, args, pages_per_group=2)
        for out in (got, v2, j1, j2):
            np.testing.assert_array_equal(out[0], 0.0)
            np.testing.assert_allclose(out[1], _jax(jx, jx.ref, args)[1],
                                       **TOL)

    def test_length_past_the_table_reads_only_its_pages(self, jx):
        # JAX's v2 is held at a group that divides the table: with a
        # ragged last group it pads the table with page 0 and reads that
        # page's rows as visible past the capacity (ROADMAP.md queue C)
        args = _inputs(2, 4, 2, 64, 4, 3, seed=6, lens=[12, 40])
        got = _port(paged_decode_attention, args)
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args), **TOL)
        np.testing.assert_allclose(got, _jax(jx, jx.v1, args), **TOL)
        np.testing.assert_allclose(
            _port(paged_decode_attention_v2, args, pages_per_group=2),
            _jax(jx, jx.v2, args, pages_per_group=3), **TOL)


class TestPagedV2Parity:
    @pytest.mark.parametrize("shape,G", [
        ((2, 8, 2, 128, 16, 7), 1),
        ((2, 8, 2, 128, 16, 7), 3),          # a ragged last group
        ((2, 4, 4, 64, 4, 7), 4),            # MHA, small pages, ragged
    ])
    def test_group_sizes(self, jx, shape, G):
        args = _inputs(*shape, seed=7)
        args[3][0] = 1
        got = _port(paged_decode_attention_v2, args, pages_per_group=G)
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args), **TOL)
        np.testing.assert_allclose(
            got, _jax(jx, jx.v2, args, pages_per_group=G), **TOL)

    def test_plain_versions_agree_at_the_default_group(self):
        args = [_t(a) for a in _inputs(2, 8, 2, 128, 16, 8, seed=9)]
        torch.testing.assert_close(paged_decode_attention_v2(*args),
                                   paged_decode_attention(*args),
                                   rtol=0, atol=0)


class TestGates:
    def test_default_group_fills_96kb_within_shared_memory(self):
        # 12 bf16 pages of 16 x 128 rows: 96 KB of K + V a group, 6 in
        # f32, at most the table; what fits shared memory is the kernel
        # source's reckoning, held on the card
        # (TestPagedKernelsOnCard.test_group_cap_fits_shared_memory)
        assert paged.default_pages_per_group(64, 16) == 12
        assert paged.default_pages_per_group(64, 16, 128, 4) == 6
        assert paged.default_pages_per_group(3, 16) == 3      # the table
        assert paged.default_pages_per_group(64, 128, 256, 4) == 1

    @pytest.mark.parametrize("H,KV,D,psz,ok", [
        (32, 8, 128, 16, True), (4, 4, 64, 1, True), (8, 1, 256, 16, True),
        (4, 2, 96, 16, False),        # a row is not a power of two pieces
        (6, 4, 128, 16, False),       # H % KV
        (16, 1, 128, 16, False),      # 16 query heads a KV head
        (4, 2, 128, 0, False), (4, 2, 256, 512, False),  # page_size
    ])
    def test_eligibility(self, H, KV, D, psz, ok):
        assert paged.paged_kernel_eligible(H, KV, D, psz) is ok

    def test_page_bytes_cap_depends_on_the_dtype(self):
        # a 32 KB page: 64 rows of 128 in f32, 128 in bf16
        assert paged.paged_kernel_eligible(8, 2, 128, 64)
        assert not paged.paged_kernel_eligible(8, 2, 128, 65)
        assert paged.paged_kernel_eligible(8, 2, 128, 128, itemsize=2)
        assert not paged.paged_kernel_eligible(8, 2, 128, 129, itemsize=2)


class TestAppendToCache:
    def test_matches_jax_in_place(self, jx):
        rng = np.random.RandomState(10)
        KV, P, psz, D, B, nj = 2, 9, 4, 64, 3, 2
        kp = rng.randn(KV, P, psz, D).astype(np.float32)
        vp = rng.randn(KV, P, psz, D).astype(np.float32)
        kn = rng.randn(B, KV, D).astype(np.float32)
        vn = rng.randn(B, KV, D).astype(np.float32)
        lens = np.asarray([5, 0, 2], np.int32)        # slot 1 idle
        tab = np.asarray([[3, 7], [0, 0], [2, 5]], np.int32)
        want = _jax(jx, lambda *a: jx.jnp.stack(jx.append(*a)[:2]),
                    [kp, vp, kn, vn, lens, tab])
        tk, tv = _t(kp), _t(vp)
        ok, ov, ol = ops.append_to_cache(tk, tv, _t(kn), _t(vn), _t(lens),
                                         _t(tab))
        assert ok is tk and ov is tv
        np.testing.assert_array_equal(ol.numpy(), lens + 1)
        # the idle row's page 0 write: any winner is fine on the trash page
        np.testing.assert_array_equal(ok.numpy()[:, 1:], want[0][:, 1:])
        np.testing.assert_array_equal(ov.numpy()[:, 1:], want[1][:, 1:])
        np.testing.assert_array_equal(ok.numpy()[:, 7, 1], kn[0])
        np.testing.assert_array_equal(ov.numpy()[:, 2, 2], vn[2])


class TestRouting:
    @pytest.fixture(autouse=True)
    def _counts(self):
        routes.reset_route_counts()
        yield

    def _call(self, args):
        return routes.paged_attention(*[_t(a) for a in args]).numpy()

    @pytest.mark.parametrize("impl,route,wrapper", [
        ("intree", "paged_intree", paged_decode_attention_v2),
        ("intree_v1", "paged_intree_v1", paged_decode_attention),
        ("reference", "paged_reference", None),
    ])
    def test_flag_picks_the_route(self, jx, impl, route, wrapper):
        args = _inputs(2, 4, 2, 128, 16, 4, seed=11)
        n = None if wrapper is None else wrapper.plain_calls
        with flags.flags_guard(paged_impl=impl):
            got = self._call(args)
        assert routes.route_counts == dict(
            {k: 0 for k in routes.route_counts}, **{route: 1})
        if wrapper is not None:
            assert wrapper.plain_calls == n + 1
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args), **TOL)

    def test_default_is_intree(self):
        assert flags.flag("FLAGS_paged_impl") == "intree"

    def test_ineligible_shape_takes_the_reference(self, jx):
        args = _inputs(2, 4, 2, 96, 16, 4, seed=12)
        got = self._call(args)
        assert routes.route_counts["paged_reference"] == 1
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args), **TOL)

    @pytest.mark.parametrize("impl,wrapper", [
        ("intree", paged_decode_attention_v2),
        ("intree_v1", paged_decode_attention),
    ])
    def test_ineligible_shape_raises_off_the_cpu(self, impl, wrapper):
        # off the CPU an ineligible shape goes to the kernel wrapper,
        # which refuses it: no plain fallback (tensors on the meta device
        # stand in for the card's here)
        args = [_t(a).to("meta")
                for a in _inputs(2, 4, 2, 96, 16, 4, seed=12)]
        n = wrapper.plain_calls
        with pytest.raises(ValueError, match="paged_kernel_eligible"):
            routes.paged_attention(*args, impl=impl)
        assert routes.route_counts["paged_reference"] == 0
        assert routes.route_counts["paged_" + impl] == 1
        assert wrapper.plain_calls == n

    def test_impl_argument_overrides_the_flag(self, jx):
        args = _inputs(2, 4, 2, 128, 16, 4, seed=11)
        n = paged_decode_attention.plain_calls
        got = routes.paged_attention(*[_t(a) for a in args],
                                     impl="intree_v1").numpy()
        assert flags.flag("FLAGS_paged_impl") == "intree"
        assert routes.route_counts["paged_intree_v1"] == 1
        assert paged_decode_attention.plain_calls == n + 1
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args), **TOL)
        with pytest.raises(ValueError, match="not one of"):
            routes.paged_attention(*[_t(a) for a in args], impl="bundled")

    def test_reference_is_the_jax_reference_on_a_zero_row(self, jx):
        # the composite's length-0 row: the mean of V, as in JAX
        args = _inputs(2, 4, 2, 64, 4, 3, seed=13, lens=[0, 7])
        got = routes.paged_attention_reference(
            *[_t(a) for a in args]).numpy()
        np.testing.assert_allclose(got, _jax(jx, jx.ref, args), **TOL)

    def test_bundled_is_refused_and_unknown_names_raise(self, monkeypatch):
        with pytest.raises(ValueError, match="no counterpart"):
            flags.set_flags({"FLAGS_paged_impl": "bundled"})
        with pytest.raises(ValueError, match="invalid value"):
            flags.set_flags({"FLAGS_paged_impl": "fast"})
        with pytest.raises(KeyError, match="unknown flag"):
            flags.set_flags({"FLAGS_nope": 1})
        assert flags.flag("FLAGS_paged_impl") == "intree"
        # the environment is validated too: no silent fallback
        monkeypatch.setenv("FLAGS_probe_impl", "bundled")
        with pytest.raises(ValueError, match="no counterpart"):
            flags.define_flag("FLAGS_probe_impl", "intree",
                              validator=flags._paged_impl_ok)


class TestSdpaPrefill:
    def test_matches_jax_at_a_ragged_length(self, jx):
        from paddle_tpu_torch.ops import flash_attention as attn
        rng = np.random.RandomState(14)
        q, k, v = (rng.randn(1, 200, 4, 64).astype(np.float32)
                   for _ in range(3))
        want = _jax(jx, lambda *a: jx.sdpa_prefill(*a, causal=True,
                                                   pad_to_flash_min=64),
                    [q, k, v])
        attn.reset_route_counts()
        got = attn.sdpa_prefill(_t(q), _t(k), _t(v), causal=True,
                                pad_to_flash_min=64)
        assert attn.route_counts["flash"] == 1
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
class TestPagedKernelsOnCard:
    """Both CUDA kernels against their plain version on the same inputs
    on the card: f32 at 2e-5 (summation order); bf16 by the relative
    errors and limits of chip_smoke.py, over the whole output and over
    each (sequence, head)'s D values (its norm floored at 1% of the
    root-mean-square head norm), since an absolute bar of 2e-2 is the
    size of the values of a long row."""

    BF16_TENSOR_LIMIT = 5e-3
    BF16_HEAD_LIMIT = 1e-2

    @classmethod
    def _assert(cls, got, want):
        if got.dtype == torch.float32:
            torch.testing.assert_close(got, want, **TOL)
            return
        w = want.float()
        d = got.float() - w
        assert float(d.norm() / w.norm()) <= cls.BF16_TENSOR_LIMIT
        wn, dn = w.norm(dim=-1), d.norm(dim=-1)
        head = dn / wn.clamp_min(1e-2 * float(w.norm()) / wn.numel() ** 0.5)
        assert float(head.max()) <= cls.BF16_HEAD_LIMIT

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are CUDA C++ "
                        "with no CPU mode")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape,lens,G", [
        ((3, 8, 2, 128, 16, 8), None, 3),
        ((2, 4, 2, 64, 4, 6), [1, 24], 4),
        ((2, 4, 4, 64, 16, 4), None, 1),
        ((2, 4, 1, 128, 16, 4), [0, 64], 2),      # a length-0 row
        ((2, 4, 2, 64, 4, 3), [12, 40], None),    # past the table
        ((4, 32, 8, 128, 16, 64), [300, 1024, 517, 1], None),
        ((2, 8, 1, 256, 16, 4), None, None), ((2, 8, 8, 32, 8, 4), None, 2),
    ])
    def test_v1_and_v2(self, dtype, shape, lens, G):
        host = _inputs(*shape, seed=21, lens=lens)
        psz, pps = shape[4], shape[5]
        if host[3][0] <= (pps - 1) * psz:     # a -1 past the live pages
            host[4][0, -1] = -1
        args = [_t(a).cuda() for a in host]
        args[:3] = [a.to(dtype) for a in args[:3]]
        want = ops.paged_decode_reference(*args)
        for fn, kw in ((paged_decode_attention, {}),
                       (paged_decode_attention_v2,
                        {} if G is None else {"pages_per_group": G})):
            n = fn.launches
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            assert fn.launches == n + 1 and got.dtype == dtype
            assert bool(torch.isfinite(got).all())
            self._assert(got, want)
            if lens is not None and lens[0] == 0:
                assert float(got[0].float().abs().max()) == 0.0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("D", paged.HEAD_DIMS)
    def test_group_cap_fits_shared_memory(self, dtype, D):
        # the largest page the gate takes stages at least one page group
        # at the most query heads a block holds, and runs right there
        isz = torch.finfo(dtype).bits // 8
        psz = paged.MAX_PAGE_BYTES // (D * isz)
        assert paged.paged_kernel_eligible(16, 2, D, psz, isz)
        assert paged.max_pages_per_group(psz, D, paged.MAX_REP, dtype) >= 1
        host = _inputs(2, 16, 2, D, psz, 2, seed=22, lens=[psz + 3, 1])
        args = [_t(a).cuda() for a in host]
        args[:3] = [a.to(dtype) for a in args[:3]]
        want = ops.paged_decode_reference(*args)
        for fn in (paged_decode_attention, paged_decode_attention_v2):
            self._assert(fn(*args), want)

    @pytest.mark.parametrize("impl", ["intree", "intree_v1"])
    def test_ineligible_shape_raises_on_the_card(self, impl):
        # D 96: no kernel, and no plain fallback on the card
        args = [_t(a).cuda() for a in _inputs(2, 4, 2, 96, 16, 4, seed=12)]
        routes.reset_route_counts()
        with pytest.raises(ValueError, match="paged_kernel_eligible"):
            routes.paged_attention(*args, impl=impl)
        assert routes.route_counts["paged_reference"] == 0
