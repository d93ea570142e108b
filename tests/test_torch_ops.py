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

import subprocess
import sys
import textwrap
import types
from pathlib import Path

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


# ------------------------------------------------- ragged's split plan
def _ragged_items(nt, kvl, ss, T, KV, rep, cap, split, psz, sms=132):
    """The bf16 kernel's work items as csrc/ragged_attention.cu enumerates
    them: (sequence, KV head, 16-row tile, split, the tile's splits, keys
    [k0, k1)) for every split that some row of its tile sees; a sequence
    of at least half of `sms` items (KV x tiles) whose keys span fewer
    than SPLIT_PAGES pages is not split."""
    out = []
    for i in range(len(nt)):
        start = int(ss[i])
        n = 0 if start < 0 or start >= T else min(max(int(nt[i]), 0),
                                                  T - start)
        hi = min(int(kvl[i]), cap)
        rows = n * rep
        if n <= 0 or hi <= 0:
            continue
        tiles = -(-rows // 16)
        whole = KV * tiles >= (sms + 1) // 2 and \
            hi <= (ops.ragged.SPLIT_PAGES - 1) * psz
        lim0 = int(kvl[i]) - int(nt[i])
        for gk in range(KV):
            for qt in range(tiles):
                last_t = (min(16 * qt + 16, rows) - 1) // rep
                tile_hi = min(lim0 + last_t + 1, cap)
                if tile_hi <= 0:
                    continue
                if whole:
                    out.append((i, gk, qt, 0, 1, 0, tile_hi))
                    continue
                ns = -(-tile_hi // split)
                for s in range(ns):
                    k0 = s * split
                    out.append((i, gk, qt, s, ns, k0,
                                min(k0 + split, tile_hi)))
    return out


class TestRaggedSplitPlan:
    """ragged_split_plan and the bf16 kernel's split-and-merge, on the
    CPU (the kernel itself runs only on the card)."""

    @pytest.mark.parametrize("S,KV,rep,T,cap,D,layout", [
        # the 8B step: slots at 300 / 1024 / idle / 517, a 128-token chunk
        (5, 8, 4, 132, 1024, 128,
         ([1, 1, 0, 1, 128], [300, 1024, 0, 517, 384])),
        # rep 7, a chunk whose tiles cross token boundaries; MLA's row
        (5, 4, 7, 40, 512, 128, ([1, 1, 1, 0, 36], [1, 129, 512, 0, 200])),
        (5, 1, 16, 20, 256, 576, ([1, 0, 1, 1, 16], [17, 0, 255, 64, 80])),
    ])
    def test_covers_each_visible_pair_once(self, S, KV, rep, T, cap, D,
                                           layout):
        nt, kvl = (np.asarray(a) for a in layout)
        ss = np.concatenate([[0], np.cumsum(nt)[:-1]])
        split, nsplit, most = ops.ragged.ragged_split_plan(
            S, KV, rep, T, cap, 132, D)
        assert split % ops.ragged.SPLIT_QUANTUM == 0
        assert nsplit == -(-cap // split)
        seen = np.zeros((KV, T * rep, cap), np.int32)
        items = _ragged_items(nt, kvl, ss, T, KV, rep, cap, split, 16)
        assert len(items) <= most
        for i, gk, qt, s, _ns, k0, k1 in items:
            for r in range(16 * qt, min(16 * qt + 16, nt[i] * rep)):
                t = r // rep
                hi = min(kvl[i] - nt[i] + t + 1, k1)
                seen[gk, ss[i] * rep + r, k0:max(hi, k0)] += 1
        want = np.zeros_like(seen)
        for i in range(S):
            for t in range(nt[i]):
                lim = min(kvl[i] - nt[i] + t + 1, cap)
                want[:, (ss[i] + t) * rep:(ss[i] + t + 1) * rep,
                     :max(lim, 0)] = 1
        np.testing.assert_array_equal(seen, want)

    def test_fills_the_card_at_the_8b_decode_step(self):
        # 4 decode slots (the chunk sequence idle) at full length: items
        # enough for every SM of the H100
        split, nsplit, _ = ops.ragged.ragged_split_plan(5, 8, 4, 132, 1024,
                                                        132, 128)
        assert 4 * 8 * nsplit >= 132
        assert split * (nsplit - 1) < 1024 <= split * nsplit

    def test_depends_on_shapes_only(self):
        import inspect
        params = list(inspect.signature(
            ops.ragged.ragged_split_plan).parameters)
        assert params == ["S", "KV", "rep", "T", "capacity", "sms",
                          "head_dim", "page_size"]
        plans = {ops.ragged.ragged_split_plan(5, 8, 4, 132, 1024, 132, 128)
                 for _ in range(3)}
        assert len(plans) == 1
        # the MLA engine's shapes keep its partials within the workspace
        split, nsplit, most = ops.ragged.ragged_split_plan(
            5, 1, 16, 132, 1024, 132, 576)
        assert most * (16 * 576 + 32) * 4 <= \
            ops.ragged.SPLIT_WORKSPACE_BYTES

    def test_split_pages_is_the_kernels(self):
        # the plan bounds a split by the table entries the bf16 kernel
        # stages (rag::SPG), which refuses a longer split
        src = (Path(ops.__file__).parent / "csrc"
               / "ragged_attention.cu").read_text()
        assert f"constexpr int SPG = {ops.ragged.SPLIT_PAGES};" in src

    def test_split_and_merge_matches_reference(self):
        # f32: each item's (acc, m, l) over its keys, merged as the kernel
        # merges (splits with l = 0 skipped), against the plain version.
        # Sequence 1 has length 0 and 3 is idle; sequence 4's first tile
        # sees no key of its last split (an item the kernel skips), and
        # sequence 5's first tile holds rows that see none of its last
        # split beside rows that do (partials with l = 0); two rows at
        # the end belong to no sequence
        rng = np.random.RandomState(11)
        S, KV, rep, D, psz, nj = 6, 2, 2, 128, 16, 32
        cap, T = nj * psz, 28
        nt = np.asarray([1, 1, 2, 0, 10, 12])
        kvl = np.asarray([300, 0, 140, 0, 258, 264])
        ss = np.concatenate([[0], np.cumsum(nt)[:-1]])
        P = S * nj + 1
        q = torch.from_numpy(rng.randn(T, KV * rep, D).astype(np.float32))
        kp = torch.from_numpy(rng.randn(KV, P, psz, D).astype(np.float32))
        vp = torch.from_numpy(rng.randn(KV, P, psz, D).astype(np.float32))
        tab = torch.from_numpy(
            (1 + rng.permutation(P - 1)[:S * nj]).reshape(S, nj)
            .astype(np.int32))
        split, nsplit, _ = ops.ragged.ragged_split_plan(S, KV, rep, T, cap,
                                                        132, D)
        assert nsplit >= 3
        scale = D ** -0.5
        out = torch.zeros_like(q)
        parts = {}
        for i, gk, qt, s, ns, k0, k1 in _ragged_items(
                nt, kvl, ss, T, KV, rep, cap, split, psz, sms=10):
            rows = torch.arange(16 * qt, min(16 * qt + 16, nt[i] * rep))
            t, hd = rows // rep, gk * rep + rows % rep
            keys = torch.arange(k0, k1)
            pages = tab[i].long()[keys // psz]
            kk, vv = kp[gk, pages, keys % psz], vp[gk, pages, keys % psz]
            sc = (q[ss[i] + t, hd] @ kk.T) * scale
            vis = keys[None, :] < (kvl[i] - nt[i] + t + 1)[:, None]
            sc = torch.where(vis, sc, torch.full_like(sc, -torch.inf))
            m = sc.amax(-1)
            p = torch.where(vis, torch.exp(sc - m.clamp_min(-1e30)[:, None]),
                            torch.zeros_like(sc))
            parts.setdefault((i, gk, qt), []).append(
                (p @ vv, m, p.sum(-1), ss[i] + t, hd))
        for (i, gk, qt), ps in parts.items():
            M = torch.stack([torch.where(l > 0, m, torch.full_like(m, -1e30))
                             for _, m, l, _, _ in ps]).amax(0)
            acc, lsum = 0.0, 0.0
            for a, m, l, _, _ in ps:
                e = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
                acc, lsum = acc + a * e[:, None], lsum + l * e
            rows_t, hd = ps[0][3], ps[0][4]
            out[rows_t, hd] = acc / torch.where(lsum > 0, lsum,
                                                torch.ones_like(lsum))[:, None]
        want = ops.ragged_attention_reference(
            q, kp, vp, torch.from_numpy(ss.astype(np.int32)),
            torch.from_numpy(nt.astype(np.int32)),
            torch.from_numpy(kvl.astype(np.int32)), tab, scale=scale)
        torch.testing.assert_close(out, want, **TOL)


def _ragged_batch(lengths, nts, H, KV, D, psz, *, seed=0, same=False,
                  poison=False, pad=2, sentinels=()):
    """A bf16 unified step on the card: sequence i owns nts[i] rows (0: an
    idle slot) at kv length lengths[i], on random pages of one pool; each
    table ends in -1 entries past its length, and `pad` trailing rows
    belong to no sequence. `sentinels` are (sequence, page index, entry)
    written INSIDE a length (-1 and entries past the pool read the clamped
    page, as the plain version reads it). With `poison`, every pool row
    past a length and every page no table names hold NaN. Returns
    (args, clean): the kernel's operands and the same with the clean
    pools, which the plain version reads."""
    g = torch.Generator().manual_seed(seed)
    S = len(lengths)
    nj = max(-(-max(lengths) // psz), 1) + 1
    need = sum(-(-n // psz) for n in lengths)
    P = need + 3                   # page 0 and two more no table names
    perm = 1 + torch.randperm(P - 1, generator=g)
    tab = torch.full((S, nj), -1, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lengths):
        k = -(-n // psz)
        tab[i, :k] = perm[used:used + k].to(torch.int32)
        used += k
    T = sum(nts) + pad
    ss = torch.tensor([sum(nts[:i]) for i in range(S)], dtype=torch.int32)
    nt = torch.tensor(nts, dtype=torch.int32)
    kvl = torch.tensor(lengths, dtype=torch.int32)
    r = lambda *sh: torch.randn(*sh, generator=g)  # noqa: E731
    q, kp = r(T, H, D), r(KV, P, psz, D)
    vp = kp if same else r(KV, P, psz, D)
    clean_tab = tab.clone()
    for i, j, entry in sentinels:
        clean_tab[i, j] = min(max(entry, 0), P - 1)
        tab[i, j] = entry
    dirty_k, dirty_v = kp.clone(), vp.clone()
    if poison:
        named = torch.zeros(P, dtype=torch.bool)
        for i, n in enumerate(lengths):
            for j in range(-(-n // psz)):
                page = int(clean_tab[i, j])
                named[page] = True
                for pool in (dirty_k, dirty_v):
                    pool[:, page, max(n - j * psz, 0):] = torch.nan
        for pool in (dirty_k, dirty_v):
            pool[:, ~named] = torch.nan
    dev = lambda t: t.cuda()  # noqa: E731
    bf = lambda t: t.to(torch.bfloat16).cuda()  # noqa: E731
    rows = [dev(ss), dev(nt), dev(kvl)]
    kd = bf(dirty_k)
    args = [bf(q), kd, kd if same else bf(dirty_v)] + rows + [dev(tab)]
    kc = bf(kp)
    clean = [args[0], kc, kc if same else bf(vp)] + rows + [dev(clean_tab)]
    return args, clean


#: GQA geometries of the card tests: rep 1 (GPT-3 6.7B), 4 (Llama-3-8B),
#: 7 (Qwen2-7B), 16 (DeepSeek-V2's latent row)
RAGGED_REPS = {1: (8, 8), 4: (8, 2), 7: (14, 2), 16: (16, 1)}


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

    @staticmethod
    def _ragged_bf16(args, clean, split=None, scale=None):
        """The bf16 kernel (the wrapper, or `split` keys a split) on
        `args` against the plain version on `clean`: finite, zeros where
        no sequence's row is, and within today's bar."""
        n = ragged_paged_attention.launches
        if split is None:
            got = ragged_paged_attention(*args, scale=scale)
        else:
            got = ops.ragged._launch(*args, scale=scale, split=split)
        torch.cuda.synchronize()
        assert ragged_paged_attention.launches == n + (split is None)
        ref = ops.ragged_attention_reference(*clean, scale=scale)
        assert torch.isfinite(got.float()).all()
        ss, nt = args[3].tolist(), args[4].tolist()
        owned = torch.zeros(got.shape[0], dtype=torch.bool)
        for a, b in zip(ss, nt):
            owned[a:a + b] = True
        assert float(got[~owned.cuda()].float().abs().sum()) == 0.0
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        return got, ref

    @pytest.mark.parametrize("split", [None, 24, 40])
    def test_ragged_bf16_lengths_cross_splits(self, split):
        # decode rows at 1, 15, 16, 17, 1023 and 8192 keys, an idle slot
        # and a 40-token chunk: with the plan's splits and with splits of
        # 24 / 40 keys, whose boundaries fall inside pages and stages
        lengths = [1, 15, 16, 17, 1023, 8192, 0, 300]
        nts = [1, 1, 1, 1, 1, 1, 0, 40]
        args, clean = _ragged_batch(lengths, nts, 32, 8, 128, 16, seed=1,
                                    poison=True)
        self._ragged_bf16(args, clean, split)

    def test_ragged_bf16_decode_only(self):
        # the engine's decode-only step: 4 slots (slot 2 idle), the chunk
        # sequence idle, its 128 rows zero; pools poisoned past lengths
        args, clean = _ragged_batch([300, 1024, 0, 517, 0], [1, 1, 0, 1, 0],
                                    32, 8, 128, 16, seed=2, poison=True,
                                    pad=128)
        self._ragged_bf16(args, clean)

    def test_ragged_bf16_sentinels_inside_lengths(self):
        # -1 and past-the-pool entries inside a length read the clamped
        # page (page 0, page P - 1), as the plain version reads them
        args, clean = _ragged_batch(
            [300, 70, 517], [1, 1, 20], 32, 8, 128, 16, seed=3,
            sentinels=((0, 3, -1), (1, 0, 10 ** 6), (2, 30, -1)))
        self._ragged_bf16(args, clean)

    @pytest.mark.parametrize("same", [False, True])
    @pytest.mark.parametrize("psz", [8, 16])
    @pytest.mark.parametrize("D", ops.ragged.HEAD_DIMS)
    @pytest.mark.parametrize("rep", sorted(RAGGED_REPS))
    def test_ragged_bf16_shapes(self, rep, D, psz, same):
        # decode rows at 1 / 37 / 300 keys, an idle slot, a 20-token chunk
        # at 70; K and V as one pool and as two; NaN past every length
        H, KV = RAGGED_REPS[rep]
        args, clean = _ragged_batch([1, 37, 300, 0, 70], [1, 1, 1, 0, 20],
                                    H, KV, D, psz, seed=4, same=same,
                                    poison=True)
        self._ragged_bf16(args, clean, scale=D ** -0.5)

    @pytest.mark.parametrize("split", [None, 24])
    @pytest.mark.parametrize("D,rep", [(128, 4), (576, 16)])
    def test_ragged_bf16_split_boundary_keys(self, D, rep, split):
        # two keys dominate every score equally, one at the first position
        # of the second split (values +1) and one early in the first (-1):
        # the output is their mean, 0; a key counted by both splits it
        # borders moves it to 1/3
        H, KV = RAGGED_REPS[rep]
        L, psz = 600, 16
        args, clean = _ragged_batch([L, L], [1, 1], H, KV, D, psz, seed=7,
                                    pad=1)
        q, kp, vp, ss, nt, kvl, tab = args
        keys = split or ops.ragged.ragged_split_plan(
            2, KV, rep, q.shape[0], tab.shape[1] * psz,
            torch.cuda.get_device_properties(0).multi_processor_count, D)[0]
        assert keys < L
        kp.zero_()
        vp.zero_()
        q.zero_()
        q[..., 0] = 8.0
        for key, val in ((keys, 1.0), (3, -1.0)):
            page, off = tab[:, key // psz].long(), key % psz
            kp[:, page, off, 0] = 8.0
            vp[:, page, off] = val
        self._ragged_bf16(args, args, split, scale=1.0)

    @pytest.mark.parametrize("D,rep", [(128, 4), (576, 16)])
    def test_ragged_bf16_rounds_p(self, D, rep):
        # one stage of at most 16 keys and one split: the kernel rounds
        # p = exp(s - m) to bf16 against the same maximum as a plain
        # version that rounds it (the TPU kernel's p.astype(v.dtype)), so
        # the two differ by summation order only and agree on nearly
        # every output; p carried unrounded moves the outputs by less than
        # a bf16 step, but flips the rounding of many of them
        H, KV = RAGGED_REPS[rep]
        args, _ = _ragged_batch([16] * 8, [1] * 8, H, KV, D, 16, seed=5,
                                pad=0)
        got = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        q, kp, vp, ss, nt, kvl, tab = args
        ks = kp[:, tab[:, 0].long()]                   # [KV, S, 16, D]
        kr = ks.permute(1, 0, 2, 3).repeat_interleave(rep, 1).float()
        vr = vp[:, tab[:, 0].long()].permute(1, 0, 2, 3) \
            .repeat_interleave(rep, 1).float()
        sc = torch.einsum("shd,shkd->shk", q.float(), kr) * D ** -0.5
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        want = (torch.einsum("shk,shkd->shd", p.bfloat16().float(), vr)
                / p.sum(-1, keepdim=True)).bfloat16()
        differ = float((got.float() != want.float()).float().mean())
        assert differ <= 0.01, differ

    def test_ragged_bf16_overlapping_rows_trap(self):
        # four sequences over the same 64 rows (outside the contract) make
        # more work items than the plan sizes the workspace for: the launch
        # traps rather than drop items or write past the workspace. In a
        # process of its own: a trap leaves the CUDA context unusable
        code = textwrap.dedent("""
            import torch
            from paddle_tpu_torch import ops
            T, H, KV, D, psz, S, nj = 64, 32, 8, 128, 16, 4, 8
            g = torch.Generator().manual_seed(0)
            q = torch.randn(T, H, D, generator=g).bfloat16().cuda()
            kp = torch.randn(KV, S * nj, psz, D,
                             generator=g).bfloat16().cuda()
            i32 = dict(dtype=torch.int32, device="cuda")
            ops.ragged_paged_attention(
                q, kp, kp, torch.zeros(S, **i32),
                torch.full((S,), T, **i32),
                torch.full((S,), nj * psz, **i32),
                torch.arange(S * nj, **i32).reshape(S, nj))
            torch.cuda.synchronize()
        """)
        r = subprocess.run([sys.executable, "-c", code],
                           cwd=Path(__file__).resolve().parent.parent,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode != 0 and "CUDA error" in r.stderr, \
            r.stderr[-2000:]


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
