"""The port's FlashMask and varlen attention against the JAX package.

Seeded numpy inputs (B 2, S 256, H 2, D 64, f32) go through the JAX
`flashmask_sdpa` (Pallas in interpret mode on the CPU, as
tests/test_flashmask_kernel.py runs it; one jitted forward + VJP a case,
shared by the module) and the port's `flashmask_attention` on CPU tensors,
whose kernel route runs the plain version (differentiated by autograd).
Bars are the reference's: 3e-5 on the forward over rows that see a key
(rows that see none are exactly 0 on both), 3e-4 on dq / dk / dv
(tests/test_flashmask_kernel.py:99, :125), for the four encodings of its
CASES with one mask head and with one a head. Varlen at 2e-5
(tests/test_varlen_attention.py:57): `flash_attn_unpadded` with equal and
with cross cu_seqlens, `flash_attn_qkvpacked`, and
`nn.functional.scaled_dot_product_attention` with and without a padding
mask. C3 (ROADMAP.md queue C): the reference's kernel and composite
disagree under causal when Sq != Sk; the port's two routes agree with the
kernel. C4: at lengths the JAX entry's kernel gate refuses, a row that
sees no key is the mean of v there and the kernel's zero in the port.

`TestFlashMaskOnCard` holds the CUDA kernels against the plain version on
the card; it needs one and skips elsewhere. On the machine with the card,
which has no JAX: python -m pytest --noconftest
tests/test_torch_flashmask.py -m cuda."""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.nn.functional.flash_attention import (
    flash_attn_qkvpacked, flash_attn_unpadded, flashmask_attention)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import (bands_from_startend, flashmask_block_kinds,
                                  flashmask_sdpa, flashmask_sdpa_bwd,
                                  flashmask_sdpa_reference)
from paddle_tpu_torch.ops.flashmask import (_band_tensor, _launch_fwd,
                                            _reference_fwd, band_hidden)

B, S, H, D = 2, 256, 2, 64
FWD_TOL = dict(atol=3e-5, rtol=3e-5)
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)
VARLEN_TOL = dict(atol=2e-5, rtol=2e-5)


def _packed_docs(cuts_by_row, S_=S):
    """causal C=1 (LTS): a key is hidden from the rows at and past its
    document's end."""
    ends = np.zeros((len(cuts_by_row), 1, S_, 1), np.int32)
    for b, cuts in enumerate(cuts_by_row):
        lo = 0
        for c in cuts:
            ends[b, 0, lo:c, 0] = c
            lo = c
    return ends


def _full(*vals):
    return np.stack([np.full((B, 1, S), x, np.int32) for x in vals], -1)


#: tests/test_flashmask_kernel.py's CASES: (startend [B, 1, S, C], causal)
CASES = {
    "causal_C1_packed_docs": (_packed_docs([[96, 160, S], [128, 224, S]]),
                              True),
    "causal_C2_band": (_full(80, 200), True),
    "noncausal_C2": (_full(192, 64), False),
    "noncausal_C4": (_full(160, 224, 32, 96), False),
}


def _per_head(se):
    """One mask head a head: head h shifts the encoding by 16 h rows."""
    return np.concatenate([np.clip(se + 16 * h, 0, S) for h in range(H)],
                          axis=1).astype(np.int32)


def _case(name):
    case, hm = name.rsplit("/", 1)
    se, causal = CASES[case]
    return (se if hm == "hm1" else _per_head(se)), causal


CASE_NAMES = [f"{c}/{hm}" for c in CASES for hm in ("hm1", "hmH")]


def _inputs(seed, Sq=S, Sk=S, B_=B, H_=H, D_=D):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B_, Sq, H_, D_), (B_, Sk, H_, D_),
                          (B_, Sk, H_, D_), (B_, Sq, H_, D_))]


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only class runs on a
    machine without JAX."""
    jax = pytest.importorskip("jax")
    import paddle_tpu
    from paddle_tpu.nn import functional as jF
    from paddle_tpu.nn.functional import flash_attention as jfa
    from paddle_tpu.ops import flash_attention, pallas_flashmask
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, paddle=paddle_tpu, F=jF, fa=jfa,
        ref=flash_attention.sdpa_reference, pm=pallas_flashmask)


def _widest_form(se, causal):
    """The same bands in the widest encoding of their causal flag: C=2
    [start, end) under causal, C=4 without (bands_from_startend maps both
    forms to equal bands; test_bands_and_block_kinds_match_jax holds the
    JAX package to the original encodings)."""
    C, full = se.shape[-1], np.full(se.shape[:-1], S, np.int32)
    if C == 1:
        return np.stack([se[..., 0], full], -1)
    if C == 2 and not causal:
        return np.stack([se[..., 0], full, 0 * full, se[..., 1]], -1)
    return se


@pytest.fixture(scope="module")
def jax_cases(jx):
    """{case: (o, dq, dk, dv)} of the JAX kernel on `_inputs(0)`: a jitted
    forward + VJP (Pallas interpret mode) over each case's bands in their
    widest encoding, so that one compiled program serves every case of a
    (causal, mask heads) pair."""
    q, k, v, do = (jx.jnp.asarray(a) for a in _inputs(0))

    def fwd_vjp(q_, k_, v_, do_, se, causal):
        o, vjp = jx.jax.vjp(lambda a, b, c: jx.pm.flashmask_sdpa(
            a, b, c, se, causal=causal), q_, k_, v_)
        return (o, *vjp(do_))

    run = jx.jax.jit(fwd_vjp, static_argnums=5)
    out = {}
    for name in CASE_NAMES:
        se, causal = _case(name)
        se = jx.jnp.asarray(_widest_form(se, causal))
        out[name] = [np.asarray(a) for a in run(q, k, v, do, se, causal)]
    return out


def _port_fwd_bwd(fn, q, k, v, do, *args, **kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fn(tq, tk, tv, *args, **kw)
    o = o[0] if isinstance(o, tuple) else o
    o.backward(torch.from_numpy(do))
    return [t.detach().numpy() for t in (o, tq.grad, tk.grad, tv.grad)]


def _visible_rows(se, causal, Sq=S, Sk=S):
    """[B, Hm, Sq] bool: rows that see at least one key."""
    bands = bands_from_startend(torch.from_numpy(se), Sq, Sk, causal)
    return (~band_hidden(bands, Sq, Sk, causal)).any(-1).numpy()


def _assert_rows(got, want, vis, tol):
    """[B, S, H, D] outputs compared on the rows that see a key; the
    others must be exactly 0 in both."""
    vis = np.broadcast_to(vis.transpose(0, 2, 1), got.shape[:3])
    np.testing.assert_allclose(got[vis], want[vis], **tol)
    assert not got[~vis].any() and not want[~vis].any()


class TestFlashMaskParity:
    @pytest.mark.parametrize("name", CASE_NAMES)
    def test_forward_and_gradients_match_the_jax_kernel(self, jax_cases,
                                                        name):
        se, causal = _case(name)
        q, k, v, do = _inputs(0)
        tfa.reset_route_counts()
        n_plain = flashmask_sdpa.plain_calls
        got = _port_fwd_bwd(flashmask_attention, q, k, v, do,
                            torch.from_numpy(se), causal=causal)
        # the public entry point took the kernel route, which runs the
        # plain version on CPU tensors
        assert tfa.route_counts["flashmask"] == 1
        assert tfa.route_counts["flashmask_composite"] == 0
        assert flashmask_sdpa.plain_calls == n_plain + 1
        want = jax_cases[name]
        _assert_rows(got[0], want[0], _visible_rows(se, causal), FWD_TOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, **GRAD_TOL)

    def test_backward_wrapper_matches_autograd(self, jax_cases):
        se, causal = _case("noncausal_C4/hmH")
        q, k, v, do = (torch.from_numpy(a) for a in _inputs(0))
        n_plain = flashmask_sdpa_bwd.plain_calls
        grads = flashmask_sdpa_bwd(q, k, v, None, None, do,
                                   torch.from_numpy(se), causal=causal)
        assert flashmask_sdpa_bwd.plain_calls == n_plain + 1
        for g, w in zip(grads, jax_cases["noncausal_C4/hmH"][1:]):
            np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)

    @pytest.mark.parametrize("case", list(CASES))
    def test_bands_and_block_kinds_match_jax(self, jx, case):
        for se in (CASES[case][0], _per_head(CASES[case][0])):
            causal = CASES[case][1]
            jb = jx.pm.bands_from_startend(jx.jnp.asarray(se), S, S, causal)
            tb = bands_from_startend(torch.from_numpy(se), S, S, causal)
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            want = jx.pm.flashmask_block_kinds(jb, S, S, 128, 128, causal)
            got = flashmask_block_kinds(tb, S, S, 128, 128, causal)
            np.testing.assert_array_equal(np.asarray(want), got.numpy())

    @pytest.mark.parametrize("name", CASE_NAMES)
    def test_kernel_tiles_skip_only_hidden_entries(self, name):
        """At the Hopper tiles (64 x 64) and a ragged length (200), a tile
        of kind 0 holds no visible entry, and every encoding skips tiles
        beyond the causal triangle's 6 of 16."""
        se, causal = _case(name)
        Sq = 200
        se = np.minimum(se[:, :, :Sq], Sq)
        bands = bands_from_startend(torch.from_numpy(se), Sq, Sq, causal)
        kinds = flashmask_block_kinds(bands, Sq, Sq, 64, 64, causal)
        vis = ~band_hidden(bands, Sq, Sq, causal)
        tiles = torch.nn.functional.pad(vis, (0, 56, 0, 56)).reshape(
            *vis.shape[:2], 4, 64, 4, 64).any(-1).any(-2)
        assert not tiles[kinds == 0].any()
        assert ((kinds == 0).sum((-1, -2)) > (6 if causal else 0)).all()


class TestC3CausalAlignment:
    """C3: the reference kernel masks causally top-left (j > i), its
    composite bottom-right (tril(k=Sk-Sq)); the port takes the kernel's
    form on both routes. The smallest input: B 1, Sq 128, Sk 256, H 1,
    D 64, C=1 with every start at Sq (no band)."""

    def _inputs(self):
        q, k, v, _ = _inputs(7, Sq=128, Sk=256, B_=1, H_=1)
        se = np.full((1, 1, 256, 1), 128, np.int32)
        return q, k, v, se

    def test_reference_routes_differ(self, jx):
        q, k, v, se = self._inputs()
        jq, jk, jv = (jx.jnp.asarray(a) for a in (q, k, v))
        kern = np.asarray(jx.jax.jit(lambda a, b, c: jx.pm.flashmask_sdpa(
            a, b, c, jx.jnp.asarray(se), causal=True))(jq, jk, jv))
        # the composite route's own call (ops/flash_attention.py:404): the
        # band mask (all visible here) under sdpa_reference(causal=True)
        comp = np.asarray(jx.ref(jq, jk, jv,
                                 mask=jx.jnp.ones((1, 1, 128, 256), bool),
                                 causal=True))
        assert np.abs(kern - comp).max() > 1.0
        # the port's two routes agree at 2e-5, and with the JAX kernel
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        tse = torch.from_numpy(se)
        kernel_route = flashmask_sdpa(tq, tk, tv, tse, causal=True).numpy()
        composite_route = tfa._flashmask_composite(tq, tk, tv, tse,
                                                   True).numpy()
        np.testing.assert_allclose(kernel_route, composite_route,
                                   **VARLEN_TOL)
        np.testing.assert_allclose(kernel_route, kern, **FWD_TOL)

    def test_rows_that_see_no_key_differ_by_route(self, jx):
        """A row that sees no key: 0 on the kernel route, the mean of v on
        the composite (the JAX composite's value)."""
        q, k, v, _ = _inputs(8, Sq=16, Sk=16, B_=1, D_=8)
        se = np.zeros((1, 1, 16, 2), np.int32)
        se[..., 0], se[..., 1] = 4, 8        # rows 4..7 see no key
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        tse = torch.from_numpy(se)
        tfa.reset_route_counts()
        comp, _ = flashmask_attention(tq, tk, tv, tse, causal=True)
        assert tfa.route_counts["flashmask_composite"] == 1  # D 8
        want = jx.fa.flashmask_attention(
            *(jx.paddle.Tensor(jx.jnp.asarray(a)) for a in (q, k, v, se)),
            causal=True)[0]
        np.testing.assert_allclose(comp.numpy(), np.asarray(want._data),
                                   **VARLEN_TOL)
        np.testing.assert_allclose(comp[0, 4:8].numpy(),
                                   np.broadcast_to(v[0].mean(0),
                                                   (4, H, 8)),
                                   **VARLEN_TOL)
        kern = flashmask_sdpa_reference(tq, tk, tv, tse, causal=True)
        assert not kern[0, 4:8].any()
        np.testing.assert_allclose(kern[0, 8:].numpy(),
                                   comp[0, 8:].numpy(), **VARLEN_TOL)


class TestC4EmptyRowsAtEveryLength:
    """C4: at lengths the JAX entry point's kernel gate refuses (not
    multiples of 128) it takes its composite, where a row that sees no key
    is the mean of v; the port keeps the kernel route and its zero, the
    value the reference kernel documents for such rows. S 16, D 64,
    causal, C=2 with every band [4, 8): rows 4-7 see no key."""

    def test_port_pins_the_kernel_zero(self, jx):
        q, k, v, g = _inputs(9, Sq=16, Sk=16, B_=1, H_=1)
        se = np.zeros((1, 1, 16, 2), np.int32)
        se[..., 0], se[..., 1] = 4, 8
        others = np.r_[0:4, 8:16]
        w = np.zeros_like(g)
        w[:, others] = g[:, others]      # a loss off the empty rows

        tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        tfa.reset_route_counts()
        out, _ = flashmask_attention(tq, tk, tv, torch.from_numpy(se),
                                     causal=True)
        assert tfa.route_counts["flashmask"] == 1
        (out * torch.from_numpy(w)).sum().backward()

        jq, jk, jv = (jx.paddle.to_tensor(a) for a in (q, k, v))
        for t in (jq, jk, jv):
            t.stop_gradient = False
        want = jx.fa.flashmask_attention(jq, jk, jv, jx.paddle.to_tensor(se),
                                         causal=True)[0]
        (want * jx.paddle.to_tensor(w)).sum().backward()
        want = np.asarray(want._data)

        # the JAX entry's composite: the mean of v; the port's kernel: 0
        np.testing.assert_allclose(
            want[0, 4:8], np.broadcast_to(v[0].mean(0), (4, 1, D)),
            **VARLEN_TOL)
        assert not out[0, 4:8].any()
        assert np.abs(want[0, 4:8]).max() > 0.1
        np.testing.assert_allclose(out.detach().numpy()[:, others],
                                   want[:, others], **VARLEN_TOL)
        for got, ref in ((tq, jq), (tk, jk), (tv, jv)):
            np.testing.assert_allclose(got.grad.numpy(),
                                       np.asarray(ref.grad._data),
                                       **VARLEN_TOL)


class TestVarlenAgainstJax:
    def _jax_tensors(self, jx, *arrays):
        return [jx.paddle.Tensor(jx.jnp.asarray(a)) for a in arrays]

    @pytest.mark.parametrize("lens_q,lens_k,causal", [
        ([96, 160], [96, 160], True),       # equal cu_seqlens
        ([40, 88], [64, 128], False),       # cross
        ([40, 88], [64, 128], True),        # cross, causal over the totals
    ])
    def test_flash_attn_unpadded(self, jx, lens_q, lens_k, causal):
        Tq, Tk = sum(lens_q), sum(lens_k)
        rng = np.random.RandomState(Tq + Tk)
        q, k, v = (rng.standard_normal((T, H, D)).astype(np.float32)
                   for T in (Tq, Tk, Tk))
        cu_q, cu_k = (np.cumsum([0] + lens).astype(np.int32)
                      for lens in (lens_q, lens_k))
        tfa.reset_route_counts()
        got, none = flash_attn_unpadded(
            *(torch.from_numpy(a) for a in (q, k, v, cu_q, cu_k)),
            causal=causal)
        assert none is None and tfa.route_counts["flash_segmented"] == 1
        want, _ = jx.fa.flash_attn_unpadded(
            *self._jax_tensors(jx, q, k, v, cu_q, cu_k), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   **VARLEN_TOL)

    def test_flash_attn_qkvpacked(self, jx):
        qkv = np.random.RandomState(4).standard_normal(
            (B, S, 3, H, D)).astype(np.float32)
        got, _ = flash_attn_qkvpacked(torch.from_numpy(qkv), causal=True)
        want, _ = jx.fa.flash_attn_qkvpacked(*self._jax_tensors(jx, qkv),
                                             causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   **VARLEN_TOL)

    @pytest.mark.parametrize("padded", [False, True])
    def test_scaled_dot_product_attention(self, jx, padded):
        q, k, v, _ = _inputs(5)
        pad = np.ones((B, S), bool)
        pad[:, 192:] = False
        mask = pad if padded else None
        tfa.reset_route_counts()
        got = scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            attn_mask=None if mask is None else torch.from_numpy(mask),
            is_causal=True)
        route = "flash_segmented" if padded else "flash"
        assert tfa.route_counts[route] == 1
        jargs = self._jax_tensors(jx, q, k, v)
        want = jx.F.scaled_dot_product_attention(
            *jargs, attn_mask=None if mask is None
            else jx.jnp.asarray(mask), is_causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   **VARLEN_TOL)


class TestRefusals:
    def test_encodings_that_need_the_other_causal_flag(self):
        x = torch.zeros(1, 8, 2, 64)
        for C, causal in ((1, False), (4, True)):
            se = torch.zeros(1, 1, 8, C, dtype=torch.int32)
            with pytest.raises(ValueError, match=f"C={C} FlashMask"):
                flashmask_attention(x, x, x, se, causal=causal)
            with pytest.raises(ValueError, match=f"C={C} FlashMask"):
                flashmask_sdpa(x, x, x, se, causal=causal)

    def test_grouped_query_attention(self):
        q, kv = torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64)
        se = torch.full((1, 1, 8, 1), 8, dtype=torch.int32)
        for fn in (flashmask_attention, flashmask_sdpa):
            with pytest.raises(ValueError, match="grouped-query"):
                fn(q, kv, kv, se, causal=True)

    def test_a_head_dim_the_hopper_kernels_lack_raises_off_the_cpu(self):
        """D 256: the JAX gate sends it to the kernel; on the CPU the
        kernel route runs the plain version (equal to the composite), and
        off the CPU it raises naming its ROADMAP entry before any device
        work (meta tensors here; the card test holds a CUDA call)."""
        q, k, v, _ = _inputs(9, Sq=32, Sk=32, B_=1, D_=256)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        se = torch.full((1, 1, 32, 1), 32, dtype=torch.int32)
        tfa.reset_route_counts()
        got, _ = flashmask_attention(tq, tk, tv, se, causal=True)
        assert tfa.route_counts["flashmask"] == 1
        np.testing.assert_allclose(
            got.numpy(), tfa._flashmask_composite(tq, tk, tv, se,
                                                  True).numpy(),
            **VARLEN_TOL)
        meta = torch.empty(1, 32, H, 256, device="meta")
        for fn in (flashmask_attention, flashmask_sdpa):
            with pytest.raises(ValueError, match="A2b"):
                fn(meta, meta, meta, se, causal=True)


@pytest.mark.cuda
class TestFlashMaskOnCard:
    """The CUDA kernels against the plain version on the card: o, lse and
    the three gradients, exact launch counts. f32 (the scalar path) at
    2e-5 on o and lse and 1e-4 on the gradients (summation order); bf16 (p
    and ds rounded to bf16 before their products) by chip_smoke.py's
    relative errors over the tensor and over each 64-position tile of a
    head (1e-2, 3e-2; a tile's norm floored at 1% of the median nonzero
    tile norm)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are CUDA C++ "
                        "with no CPU mode")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _assert(got, want, dtype, grad=False):
        got, want = got.detach().float(), want.detach().float()
        assert torch.isfinite(got).all()
        if dtype == torch.float32:
            tol = dict(atol=1e-4, rtol=1e-4) if grad else \
                dict(atol=2e-5, rtol=2e-5)
            torch.testing.assert_close(got, want, **tol)
            return
        B_, S_, H_, D_ = want.shape
        d = got - want
        assert float(d.norm() / want.norm()) <= 1e-2
        pad = (0, 0, 0, 0, 0, (-S_) % 64)
        w, d = (torch.nn.functional.pad(t, pad).reshape(B_, -1, 64, H_, D_)
                for t in (want, d))
        wn, dn = w.norm(dim=(2, 4)), d.norm(dim=(2, 4))
        # the floor from the tiles that are not zero: a band can leave
        # half the rows of a head without a key
        floor = 1e-2 * float(wn[wn > 0].median())
        assert float((dn / wn.clamp_min(floor)).max()) <= 3e-2

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("Dh", [64, 128])
    @pytest.mark.parametrize("name,Sq,Sk", [
        ("causal_C1_packed_docs/hm1", 256, 256),
        ("causal_C2_band/hmH", 200, 200),      # ragged tiles, empty rows
        ("noncausal_C2/hm1", 160, 256),        # Sq < Sk
        ("noncausal_C4/hmH", 256, 200),        # Sq > Sk, ragged keys
        ("causal_C1_packed_docs/hmH", 128, 256),  # C3's shape
    ])
    def test_kernel_matches_plain(self, dtype, Dh, name, Sq, Sk):
        se, causal = _case(name)
        se = torch.from_numpy(np.minimum(se[:, :, :Sk], Sq)).cuda()
        g = torch.Generator("cuda").manual_seed(Sq + Sk + Dh)
        r = lambda S_: torch.randn(B, S_, H, Dh, device="cuda",  # noqa: E731
                                   generator=g).to(dtype)
        q, k, v, do = r(Sq), r(Sk), r(Sk), r(Sq)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n_f, n_b = flashmask_sdpa.launches, flashmask_sdpa_bwd.launches
        n_p = flashmask_sdpa.plain_calls
        o = flashmask_sdpa(*leaves, se, causal=causal)
        o.backward(do)
        torch.cuda.synchronize()
        assert flashmask_sdpa.launches == n_f + 1
        assert flashmask_sdpa_bwd.launches == n_b + 1
        assert flashmask_sdpa.plain_calls == n_p
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = flashmask_sdpa_reference(*ref_leaves, se, causal=causal)
        ref.backward(do)
        self._assert(o, ref, dtype)
        for a, b_ in zip(leaves, ref_leaves):
            self._assert(a.grad, b_.grad, dtype, grad=True)
        _, lse_ref = _reference_fwd(q, k, v, se, causal, Dh ** -0.5)
        _, lse = _launch_fwd(q, k, v, _band_tensor(se, Sq, Sk, causal,
                                                   q.device),
                             causal, Dh ** -0.5)
        torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=2e-5)

    def test_refuses_what_it_cannot_launch(self):
        x = torch.zeros(1, 16, 2, 256, device="cuda")
        se = torch.full((1, 1, 16, 1), 16, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="A2b"):
            flashmask_attention(x, x, x, se, causal=True)
        x = torch.zeros(1, 16, 2, 64, device="cuda", dtype=torch.float16)
        with pytest.raises(TypeError):
            flashmask_sdpa(x, x, x, se, causal=True)
