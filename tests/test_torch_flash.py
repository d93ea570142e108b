"""The port's flash attention against the JAX package.

Seeded numpy inputs (B 1, H 2, D 64, S 128) go through the JAX
`flash_sdpa` (Pallas in interpret mode on the CPU, as
tests/test_flash_kernel.py runs it), JAX's `sdpa_reference`, and the
port's `flash_sdpa` on CPU tensors, which runs its plain version
(differentiated by autograd). Tolerances are the JAX tests' own: 2e-5 on
the forward and 1e-4 on dq / dk / dv, in f32. Rows that see no key are
zero under both flash versions and are compared with the composite only
where some key is visible.

The routing of `ops.flash_attention.sdpa` is held to JAX's `sdpa` (which
runs the composite on the CPU) the same way.

`TestFlashOnCard` holds the CUDA kernels against the plain version on
the card; it needs one and skips elsewhere. On the machine with the
card, which has no JAX: python -m pytest --noconftest
tests/test_torch_flash.py -m cuda."""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import (flash_kernel_eligible, flash_sdpa,
                                  flash_sdpa_bwd, flash_sdpa_reference)
from paddle_tpu_torch.ops.flash import _launch_fwd, _reference_fwd, _segments

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only class runs on a
    machine without JAX."""
    jax = pytest.importorskip("jax")
    from paddle_tpu.ops import flash_attention, pallas_flash
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, flash=pallas_flash.flash_sdpa,
        ref=flash_attention.sdpa_reference, sdpa=flash_attention.sdpa)


def _inputs(Sq, Sk, seed, B=1, H=2, D=64):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32)
               for S in (Sq, Sk, Sk))
    do = rng.randn(B, Sq, H, D).astype(np.float32)
    return q, k, v, do


def _jax_fwd_bwd(jx, fn, q, k, v, do):
    o, vjp = jx.jax.vjp(fn, *(jx.jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in (o, *vjp(jx.jnp.asarray(do)))]


def _port_fwd_bwd(q, k, v, do, **kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = flash_sdpa.plain_calls
    o = flash_sdpa(tq, tk, tv, **kw)
    assert flash_sdpa.plain_calls == before + 1
    o.backward(torch.from_numpy(do))
    return [t.detach().numpy() for t in (o, tq.grad, tk.grad, tv.grad)]


def _close(got, want, tol, rows=None):
    for g, w in zip(got, want):
        if rows is not None:
            g, w = g[:, rows], w[:, rows]
        np.testing.assert_allclose(g, w, **tol)


class TestFlashParity:
    @pytest.mark.parametrize("Sq,Sk,causal", [
        (128, 128, True),
        (128, 128, False),
        (64, 128, True),       # causal Sq < Sk: bottom-right aligned
    ])
    def test_matches_jax_flash_and_composite(self, jx, Sq, Sk, causal):
        q, k, v, do = _inputs(Sq, Sk, seed=Sq + Sk + causal)
        got = _port_fwd_bwd(q, k, v, do, causal=causal)
        want = _jax_fwd_bwd(jx, lambda a, b, c: jx.flash(a, b, c,
                                                         causal=causal),
                            q, k, v, do)
        comp = _jax_fwd_bwd(jx, lambda a, b, c: jx.ref(a, b, c,
                                                       causal=causal),
                            q, k, v, do)
        for ref in (want, comp):
            _close(got[:1], ref[:1], FWD_TOL)
            _close(got[1:], ref[1:], GRAD_TOL)

    def test_hidden_rows_are_zero_without_nan(self, jx):
        # causal Sq > Sk: rows 0..63 see no key
        Sq, Sk = 128, 64
        q, k, v, do = _inputs(Sq, Sk, seed=3)
        got = _port_fwd_bwd(q, k, v, do, causal=True)
        want = _jax_fwd_bwd(jx, lambda a, b, c: jx.flash(a, b, c,
                                                         causal=True),
                            q, k, v, do)
        assert all(np.isfinite(a).all() for a in got)
        np.testing.assert_array_equal(got[0][:, :Sq - Sk], 0.0)
        np.testing.assert_array_equal(got[1][:, :Sq - Sk], 0.0)
        _close(got[:1], want[:1], FWD_TOL)
        _close(got[1:], want[1:], GRAD_TOL)
        visible = np.arange(Sq) + (Sk - Sq) >= 0
        comp = np.asarray(jx.ref(*(jx.jnp.asarray(a) for a in (q, k, v)),
                                 causal=True))
        _close(got[:1], [comp], FWD_TOL, rows=visible)
        _, lse = _reference_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=True)
        assert bool((lse[:, :, :Sq - Sk] == np.float32(1e30)).all())

    def test_segment_ids(self, jx):
        q, k, v, do = _inputs(128, 128, seed=4)
        seg = np.random.RandomState(5).randint(0, 3, (1, 128)).astype(
            np.int32)
        got = _port_fwd_bwd(q, k, v, do, causal=True,
                            segment_ids_q=torch.from_numpy(seg),
                            segment_ids_kv=torch.from_numpy(seg))
        js = jx.jnp.asarray(seg)
        want = _jax_fwd_bwd(jx, lambda a, b, c: jx.flash(
            a, b, c, causal=True, segment_ids_q=js, segment_ids_kv=js),
            q, k, v, do)
        mask = (js[:, :, None] == js[:, None, :])[:, None]
        comp = _jax_fwd_bwd(jx, lambda a, b, c: jx.ref(
            a, b, c, mask=mask, causal=True), q, k, v, do)
        for ref in (want, comp):
            _close(got[:1], ref[:1], FWD_TOL)
            _close(got[1:], ref[1:], GRAD_TOL)

    def test_backward_wrapper_plain_version(self):
        q, k, v, do = (torch.from_numpy(a) for a in _inputs(64, 96, seed=6))
        o, lse = _reference_fwd(q, k, v, causal=True)
        before = flash_sdpa_bwd.plain_calls
        got = flash_sdpa_bwd(q, k, v, o, lse, do, causal=True)
        assert flash_sdpa_bwd.plain_calls == before + 1
        want = _port_fwd_bwd(*(t.numpy() for t in (q, k, v, do)),
                             causal=True)[1:]
        _close([g.numpy() for g in got], want, GRAD_TOL)


class TestRouting:
    def test_gate(self):
        assert flash_kernel_eligible(200, 77, 64)       # ragged lengths
        assert flash_kernel_eligible(8192, 8192, 128)
        assert not flash_kernel_eligible(128, 128, 32)
        assert not flash_kernel_eligible(128, 128, 256)
        q = torch.zeros(1, 16, 2, 32)
        assert tfa.sdpa_path(q, q) == "composite"
        q = torch.zeros(1, 16, 2, 64)
        assert tfa.sdpa_path(q, q, causal=True) == "flash"
        assert tfa.sdpa_path(q, q, dropout_p=0.1) == "composite"
        pad = torch.ones(1, 16, dtype=torch.bool)
        assert tfa.sdpa_path(q, q, mask=pad) == "flash_segmented"
        assert tfa.sdpa_path(q, q, mask=pad[:, None, None]) == \
            "flash_segmented"
        assert tfa.sdpa_path(q, q, mask=torch.zeros(16, 16)) == "composite"

    @pytest.mark.parametrize("mask_kind", ["none", "key_padding",
                                           "additive"])
    def test_sdpa_matches_jax(self, jx, mask_kind):
        q, k, v, _ = _inputs(32, 32, seed=9)
        mask_np = None
        if mask_kind == "key_padding":
            mask_np = np.ones((1, 32), bool)
            mask_np[0, 20:] = False         # padded tail: rows keep key 0
        elif mask_kind == "additive":
            mask_np = np.random.RandomState(2).randn(32, 32).astype(
                np.float32)
        route = {"none": "flash", "key_padding": "flash_segmented",
                 "additive": "composite"}[mask_kind]
        before = dict(tfa.route_counts)
        got = tfa.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                       mask=None if mask_np is None else
                       torch.from_numpy(mask_np), causal=True)
        assert tfa.route_counts[route] == before[route] + 1
        want = jx.sdpa(*(jx.jnp.asarray(a) for a in (q, k, v)),
                       mask=None if mask_np is None else
                       jx.jnp.asarray(mask_np), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)

    def test_flash_attention_returns_no_softmax(self):
        q = torch.randn(1, 16, 2, 64,
                        generator=torch.Generator().manual_seed(0))
        out, sm = tfa.flash_attention(q, q, q, causal=True)
        assert sm is None
        torch.testing.assert_close(out, flash_sdpa_reference(q, q, q,
                                                             causal=True))

    def test_refuses_other_devices(self):
        x = torch.empty(1, 8, 2, 64, device="meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            flash_sdpa(x, x, x)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
class TestFlashOnCard:
    """The CUDA kernels against the plain version on the same inputs on
    the card: o, lse and the three gradients. f32 (the scalar path) at
    2e-5 on o and lse and 1e-4 on the gradients (summation order, the JAX
    tests' bars). bf16 (p and ds are rounded to bf16 before their
    products, the plain version keeps f32) by the relative errors and
    limits of chip_smoke.py: over the tensor, and over each tile of 64
    consecutive positions of one head (its norm floored at 1% of the
    median tile norm), so that small late rows and keys are held too."""

    BF16_TENSOR_LIMIT = 1e-2
    BF16_TILE_LIMIT = 3e-2

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are CUDA C++ "
                        "with no CPU mode")
        torch.backends.cuda.matmul.allow_tf32 = False

    @classmethod
    def _assert(cls, got, want, dtype, grad=False):
        got, want = got.detach().float(), want.detach().float()
        if dtype == torch.float32:
            tol = GRAD_TOL if grad else FWD_TOL
            torch.testing.assert_close(got, want, **tol)
            return
        B, S, H, D = want.shape
        d = got - want
        assert float(d.norm() / want.norm()) <= cls.BF16_TENSOR_LIMIT
        pad = (0, 0, 0, 0, 0, (-S) % 64)
        w, d = (torch.nn.functional.pad(t, pad).reshape(B, -1, 64, H, D)
                for t in (want, d))
        wn, dn = w.norm(dim=(2, 4)), d.norm(dim=(2, 4))
        tile = dn / wn.clamp_min(1e-2 * float(wn.median()))
        assert float(tile.max()) <= cls.BF16_TILE_LIMIT

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("Sq,Sk,causal,seg", [
        (256, 256, True, False),
        (256, 256, False, False),
        (200, 200, True, True),       # ragged tiles, segments
        (200, 200, False, True),      # ragged, no causal mask to hide
        (96, 160, True, False),       # Sq < Sk
        (96, 160, False, False),      # ragged keys, no causal mask
        (160, 96, True, False),       # Sq > Sk: hidden rows
    ])
    def test_kernel_matches_plain(self, dtype, D, Sq, Sk, causal, seg):
        g = torch.Generator("cuda").manual_seed(Sq + Sk + D)
        B, H = 2, 3
        r = lambda S: torch.randn(B, S, H, D, device="cuda",  # noqa: E731
                                  generator=g).to(dtype)
        q, k, v, do = r(Sq), r(Sk), r(Sk), r(Sq)
        kw = dict(causal=causal)
        if seg:
            s = torch.randint(0, 3, (B, Sq), device="cuda", generator=g)
            kw.update(segment_ids_q=s, segment_ids_kv=s)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n_f, n_b = flash_sdpa.launches, flash_sdpa_bwd.launches
        o = flash_sdpa(*leaves, **kw)
        o.backward(do)
        torch.cuda.synchronize()
        assert flash_sdpa.launches == n_f + 1
        assert flash_sdpa_bwd.launches == n_b + 1
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = flash_sdpa_reference(*ref_leaves, **kw)
        ref.backward(do)
        self._assert(o, ref, dtype)
        for a, b in zip(leaves, ref_leaves):
            assert torch.isfinite(a.grad).all()
            self._assert(a.grad, b.grad, dtype, grad=True)
        _, lse_ref = _reference_fwd(q, k, v, **kw)
        sq, skv = _segments(B, Sq, Sk, kw.get("segment_ids_q"),
                            kw.get("segment_ids_kv"), q.device)
        _, lse = _launch_fwd(q, k, v, sq, skv, causal, D ** -0.5)
        torch.testing.assert_close(lse, lse_ref, **FWD_TOL)

    @pytest.mark.parametrize("D,Sq,Sk,causal", [
        (64, 1024, 1024, True),       # 8 q tiles, the K / V ring wraps
        (128, 1024, 1024, True),
        (128, 1000, 1000, True),      # ragged last tiles
        (64, 1000, 1000, True),
        (128, 1000, 1100, True),      # Sq < Sk
        (128, 1100, 1000, True),      # Sq > Sk: rows that see no key
        (64, 1024, 900, False),
        (128, 1, 300, True),          # one row
        (128, 1, 300, False),
        (64, 129, 129, True),         # one row past a 128-row tile
        (128, 129, 257, False),
    ])
    def test_ring_and_edges(self, D, Sq, Sk, causal):
        # bf16 (the wgmma / TMA kernels) across tile and ring boundaries
        self.test_kernel_matches_plain(torch.bfloat16, D, Sq, Sk, causal,
                                       False)

    @pytest.mark.parametrize("Sq,Sk,causal", [
        (1024, 1024, True), (1000, 1000, True), (129, 200, False),
        (1, 300, True), (200, 150, True)])
    def test_head_dim_192_forward(self, Sq, Sk, causal):
        g = torch.Generator("cuda").manual_seed(Sq + Sk)
        q, k, v = (torch.randn(2, S, 3, 192, device="cuda", generator=g)
                   .to(torch.bfloat16) for S in (Sq, Sk, Sk))
        n_f = flash_sdpa.launches
        o = flash_sdpa(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_sdpa.launches == n_f + 1
        self._assert(o, flash_sdpa_reference(q, k, v, causal=causal),
                     torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim 192"):
            flash_sdpa_bwd(q, k, v, o, torch.zeros(2, 3, Sq, device="cuda"),
                           torch.ones_like(o), causal=causal)

    @pytest.mark.parametrize("layout", ["packed_qkv", "heads_major"])
    def test_strided_inputs_bf16(self, layout):
        # views read through their strides by the tensor maps: q / k / v of
        # one [B, S, 3, H, D] projection, or [B, H, S, D] transposed
        g = torch.Generator("cuda").manual_seed(1)
        B, S, H, D = 2, 300, 3, 128
        if layout == "packed_qkv":
            qkv = torch.randn(B, S, 3, H, D, device="cuda",
                              generator=g).to(torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn(B, H, S, D, device="cuda", generator=g)
                       .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        assert not q.is_contiguous()
        do = torch.randn(B, S, H, D, device="cuda",
                         generator=g).to(torch.bfloat16)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        n_f, n_b = flash_sdpa.launches, flash_sdpa_bwd.launches
        o = flash_sdpa(*leaves, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        assert flash_sdpa.launches == n_f + 1
        assert flash_sdpa_bwd.launches == n_b + 1
        ref_leaves = [t.detach().contiguous().requires_grad_()
                      for t in (q, k, v)]
        ref = flash_sdpa_reference(*ref_leaves, causal=True)
        ref.backward(do)
        self._assert(o, ref, torch.bfloat16)
        for a, b in zip(leaves, ref_leaves):
            assert torch.isfinite(a.grad).all()
            self._assert(a.grad, b.grad, torch.bfloat16, grad=True)

    def test_strided_inputs(self):
        # q as a view of a wider projection: the kernels read its strides
        g = torch.Generator("cuda").manual_seed(0)
        qkv = torch.randn(1, 128, 3, 2, 64, device="cuda", generator=g)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        got = flash_sdpa(q, k, v, causal=True)
        torch.testing.assert_close(
            got, flash_sdpa_reference(q, k, v, causal=True), **FWD_TOL)

    def test_refuses_what_it_cannot_launch(self):
        x = torch.zeros(1, 16, 2, 32, device="cuda")
        with pytest.raises(ValueError, match="head_dim"):
            flash_sdpa(x, x, x)
        x = torch.zeros(1, 16, 2, 64, device="cuda", dtype=torch.float16)
        with pytest.raises(TypeError):
            flash_sdpa(x, x, x)
