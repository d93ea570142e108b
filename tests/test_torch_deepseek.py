"""The port's MLA slice (DeepSeek-V2) against the JAX package on the CPU.

Two seeded tiny JAX DeepSeekV2ForCausalLM (deepseek_v2_tiny_config(
moe_dropless=True): 2 layers, the first dense, 4 routed experts; with
its q-lora, and with q_lora_rank=None) carry their weights into the
port's models (extract_state -> numpy -> load_reference_state). Then:

- kernels, plain versions against the JAX kernels (Pallas in interpret
  mode, as the JAX tests run them): `mla_decode_attention` on the cases
  of tests/test_pallas_mla.py (a block not dividing T, length 1 with
  dead blocks) in f32 at 2e-5; `fused_append_rows` exactly;
  `int4_dequantize` bit for bit against JAX's `int4_dequantize` and
  `weight_dequantize`, odd N included; the MLA layout of
  `qkv_rope_append_reference` against JAX `fused_qkv_rope_append(
  lora_rank=r)`, fp and int8, q and pool rows at 2e-5; the ragged plain
  version at one KV head of D = r + dr against JAX
  `ragged_paged_attention` at 2e-5;
- the models: state keys equal extract_state's, logits with and
  without q-lora within 2e-5;
- generation: `generate` and `generate_cached` greedy tokens identical
  to JAX's under FLAGS_mla_decode_impl "fused", "xla" and "auto" (both
  sides; JAX's "auto" takes its "xla" route at the tiny rank, so one
  JAX run serves both), the composite's decode windows counted, the fp
  decode trees byte for byte JAX's `_decode_params`,
  quantized `generate_cached` request by request equal to the JAX
  engine's tokens under that layout;
- `ServingEngine` greedy tokens identical to the JAX engine's on a
  seeded join/leave trace: the fused chain without q-lora (the MLA site
  of fused_qkv_rope_append), the split chain with q-lora
  (fused_append_rows), int8 on the fused chain without q-lora and int4
  with q-lora (the split front, int4_dequantize), each with its plain
  calls a layer a step, and the int8 / int4 engines' trees byte for
  byte the JAX engines' (a JAX weight quantization costs seconds, so
  the engine runs' trees are the ones compared);
- the refusals: the alternating path of an MLA model, flash_sdpa_bwd at
  head dim 192, the MLA site with int4 weights, "auto" decode on the
  card at a shape `mla_kernel_eligible` refuses.

All in f32 with JAX at "highest" matmul precision. `TestMlaOnCard`
holds each new kernel, ragged at D 576 and flash at D 192 against their
plain versions on the card (skipped without one; on the machine with
the card, which has no JAX: python -m pytest --noconftest
tests/test_torch_deepseek.py -m cuda).
"""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import ops
from paddle_tpu_torch.flags import flags_guard
from paddle_tpu_torch.ops.fused import append_rows_reference, \
    fused_append_rows
from paddle_tpu_torch.ops.megafront import fused_qkv_rope_append, \
    qkv_rope_append_reference
from paddle_tpu_torch.ops.mla import mla_decode_attention, \
    mla_decode_reference, mla_kernel_eligible, mla_split_plan
from paddle_tpu_torch.ops.quant import int4_dequantize, weight_quantize
from paddle_tpu_torch.ops.ragged import ragged_attention_reference

NEW = 3
QUANT = ("int8", "int4")
IMPLS = ("fused", "xla", "auto")


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only class runs on a
    machine without JAX."""
    jax = pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu import generation as jgen
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.flags import flags_guard as jflags
    from paddle_tpu.jit import _StateSwap, bind_state, extract_state
    from paddle_tpu.models import deepseek as jds
    from paddle_tpu.ops import fused as jfused
    from paddle_tpu.ops import pallas_megafront, pallas_mla, pallas_ragged
    from paddle_tpu.ops import quant as jquant
    from paddle_tpu.serving import ServingEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, paddle=paddle, gen=jgen, Tensor=Tensor,
        flags=jflags, StateSwap=_StateSwap, bind_state=bind_state,
        extract_state=extract_state, ds=jds, fused=jfused,
        megafront=pallas_megafront, mla=pallas_mla, ragged=pallas_ragged,
        quant=jquant, Engine=ServingEngine)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# ------------------------------------------------------------- kernels
MLA_CASES = [  # B, nh, r, dr, T, lengths (tests/test_pallas_mla.py)
    (3, 4, 128, 16, 96, [96, 1, 37]),
    (2, 8, 128, 8, 80, [80, 50]),        # a block of 32 not dividing T
    (1, 4, 128, 8, 256, [1]),            # length 1, every other block dead
]


class TestMlaDecodeParity:
    @pytest.mark.parametrize("B,nh,r,dr,T,lens", MLA_CASES)
    def test_plain_matches_jax_kernel(self, jx, B, nh, r, dr, T, lens):
        qe, qp = _rand((B, nh, r), 0), _rand((B, nh, dr), 1)
        cl, cp = _rand((B, T, r), 2), _rand((B, T, dr), 3)
        lens = np.asarray(lens, np.int32)
        scale = 0.1
        with jx.jax.default_matmul_precision("highest"):
            want = np.asarray(jx.mla.mla_decode_attention(
                *map(jx.jnp.asarray, (qe, qp, cl, cp, lens)), scale=scale,
                block_t=32))
        before = mla_decode_attention.plain_calls
        got = mla_decode_attention(*map(_t, (qe, qp, cl, cp, lens)),
                                   scale=scale)
        assert mla_decode_attention.plain_calls == before + 1
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
        if lens[0] == 1:
            np.testing.assert_allclose(got.numpy()[0],
                                       np.broadcast_to(cl[0, 0], (nh, r)),
                                       atol=2e-5)

    def test_dead_rows_are_never_multiplied(self):
        # the cache past a length holds garbage; NaN there must not leak
        qe, qp = _t(_rand((2, 4, 32, ), 4)), _t(_rand((2, 4, 32), 5))
        cl, cp = _t(_rand((2, 40, 32), 6)), _t(_rand((2, 40, 32), 7))
        lens = torch.tensor([7, 0], dtype=torch.int32)
        want = mla_decode_reference(qe, qp, cl, cp, lens, scale=0.2)
        cl[0, 7:] = float("nan")
        cp[1] = float("nan")
        got = mla_decode_reference(qe, qp, cl, cp, lens, scale=0.2)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert (got[1] == 0).all()          # length 0: zeros

    def test_eligibility_gate(self):
        assert mla_kernel_eligible(16, 512, 64)       # DeepSeek-V2
        assert mla_kernel_eligible(4, 64, 32)
        assert not mla_kernel_eligible(4, 16, 8)      # the tiny config
        assert not mla_kernel_eligible(3, 128, 64)    # odd heads
        assert not mla_kernel_eligible(16, 1024, 64)  # past the registers


def split_ranges(length: int, T: int, rows: int, nsplit: int):
    """The live cache rows [t0, t1) that each split of one sequence of
    `length` tokens reads, as csrc/mla.cu computes them (t0 = s rows, t1 =
    min(t0 + rows, length); an empty range: the split writes l = 0 and the
    merge skips it)."""
    n = min(max(length, 0), T)
    return [(s * rows, max(s * rows, min(s * rows + rows, n)))
            for s in range(nsplit)]


class TestMlaSplitPlan:
    """The bf16 kernel's split plan, a host function of (B, T, SMs): every
    live row of a sequence is read by exactly one split, dead splits read
    none, and the grid reaches the SM count (132 on an H100 SXM)."""

    @pytest.mark.parametrize("B,T,sms", [(4, 544, 132), (8, 8192, 132),
                                         (2, 40, 132), (3, 5, 8)])
    def test_rows_covered_once_and_grid_filled(self, B, T, sms):
        rows, nsplit = mla_split_plan(B, T, sms)
        assert rows % 16 == 0 and rows >= 16
        assert (nsplit - 1) * rows < T <= nsplit * rows
        assert B * nsplit >= sms or rows == 16
        cuts = {0, 1, T, rows - 1, rows, rows + 1, T - 1}
        for n in sorted(c for c in cuts if 0 <= c <= T):
            ranges = split_ranges(n, T, rows, nsplit)
            seen = [t for lo, hi in ranges for t in range(lo, hi)]
            assert seen == list(range(n))
            # a split past the length reads nothing (the merge skips it)
            assert all(hi == lo for lo, hi in ranges if lo >= n)

    def test_decode_shapes(self):
        # DeepSeek-V2-Lite's cached decode at 4 x 544 and 8 x 8192
        assert mla_split_plan(4, 544, 132) == (16, 34)
        assert mla_split_plan(8, 8192, 132) == (480, 18)


class TestAppendRowsParity:
    def test_exact_against_jax(self, jx):
        T, KV, D, P, psz = 9, 1, 24, 6, 4
        rows = _rand((T, KV, D), 8)
        pages = _rand((KV, P, psz, D), 9)
        # the JAX kernel's contract: tokens sharing a page are adjacent
        page = np.asarray([1, 1, 2, 2, 5, 3, 0, 0, 4], np.int32)
        off = np.asarray([0, 1, 3, 1, 2, 0, 0, 0, 3], np.int32)
        want = np.asarray(jx.fused.fused_append_rows(
            *map(jx.jnp.asarray, (pages, rows, page, off))))
        tp = _t(pages.copy())
        before = fused_append_rows.plain_calls
        out = fused_append_rows(tp, _t(rows), _t(page), _t(off))
        assert out is tp and fused_append_rows.plain_calls == before + 1
        # the trash page 0 takes duplicate rows: which one wins is the
        # contract's "garbage"; every other slot must match exactly
        np.testing.assert_array_equal(tp.numpy()[:, 1:], want[:, 1:])

    def test_pages_are_clamped(self):
        pages = torch.zeros(1, 3, 2, 8)
        rows = torch.ones(2, 1, 8)
        append_rows_reference(pages, rows, torch.tensor([-1, 7]),
                              torch.tensor([5, -2]))
        assert pages[0, 0, 1].eq(1).all() and pages[0, 2, 0].eq(1).all()


class TestInt4DequantizeParity:
    @pytest.mark.parametrize("K,N", [(64, 256), (16, 37)])
    def test_bitwise_against_jax(self, jx, K, N):
        # the packing itself is held to JAX's by tests/test_torch_quant.py
        qw, s = weight_quantize(_t(_rand((K, N), K + N)), "weight_only_int4")
        before = int4_dequantize.plain_calls
        got = int4_dequantize(qw, s)
        assert int4_dequantize.plain_calls == before + 1
        assert got.dtype == torch.float32 and tuple(got.shape) == (K, N)
        wants = jx.jax.jit(lambda q, sc: (
            jx.quant.int4_dequantize(q, sc),
            jx.quant.weight_dequantize(q, sc, "weight_only_int4")))(
                jx.jnp.asarray(qw.numpy()), jx.jnp.asarray(s.numpy()))
        for want in wants:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestMlaQkvRopeAppendParity:
    @pytest.mark.parametrize("algo", [None, "weight_only_int8"])
    def test_mla_layout_matches_jax(self, jx, algo):
        T, H, nh, dn, dr, r, P, psz = 6, 32, 2, 8, 8, 16, 4, 4
        N = nh * (dn + dr) + r + dr
        h = _rand((T, H), 10)
        w = _rand((H, N), 11, 0.2)
        g = 1.0 + _rand((r,), 12, 0.1)
        pos = np.arange(T)
        inv = 1.0 / 10000 ** (np.arange(0, dr, 2) / dr)
        cos = np.cos(np.outer(pos, inv)).astype(np.float32)
        sin = np.sin(np.outer(pos, inv)).astype(np.float32)
        pool = _rand((1, P, psz, r + dr), 13)
        page = np.asarray([1, 1, 2, 2, 3, 3], np.int32)
        off = np.asarray([0, 1, 0, 1, 0, 1], np.int32)
        if algo:
            qw, s = weight_quantize(_t(w), algo)
            tw, ts = qw, s
            jw, js = jx.jnp.asarray(qw.numpy()), jx.jnp.asarray(s.numpy())
        else:
            tw, ts, jw, js = _t(w), None, jx.jnp.asarray(w), None
        kw = dict(heads=nh, algo=algo, eps=1e-6, nope_dim=dn, rope_dim=dr,
                  lora_rank=r)
        with jx.jax.default_matmul_precision("highest"):
            jq, jpool = jx.megafront.fused_qkv_rope_append(
                jx.jnp.asarray(h), jw, js, None, jx.jnp.asarray(cos),
                jx.jnp.asarray(sin), jx.jnp.asarray(pool), None,
                jx.jnp.asarray(page), jx.jnp.asarray(off),
                norm_weight=jx.jnp.asarray(g), **kw)
        for fn in (qkv_rope_append_reference, fused_qkv_rope_append):
            tpool = _t(pool.copy())
            q, out = fn(_t(h), tw, ts, None, _t(cos), _t(sin), tpool, None,
                        _t(page), _t(off), norm_weight=_t(g), **kw)
            assert out is tpool and tuple(q.shape) == (T, nh, dn + dr)
            np.testing.assert_allclose(q.numpy(), np.asarray(jq),
                                       atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool),
                                       atol=2e-5, rtol=2e-5)

    def test_refusals(self):
        t = torch.zeros(2, 8)
        with pytest.raises(NotImplementedError, match="no packed-int4"):
            fused_qkv_rope_append(t, t, None, None, t, t, t, None, t, t,
                                  heads=1, algo="weight_only_int4",
                                  nope_dim=2, rope_dim=2, lora_rank=2)
        with pytest.raises(ValueError, match="one latent pool"):
            fused_qkv_rope_append(t, t, None, None, t, t, t, t, t, t,
                                  heads=1, nope_dim=2, rope_dim=2,
                                  lora_rank=2)


class TestRaggedMlaParity:
    def test_one_latent_head_matches_jax(self, jx):
        # the MLA engine's call: one pool as K and V, KV 1, D = r + dr,
        # rep = nh; two decode rows, a 5-row chunk, an idle slot
        nh, D, P, psz, nj = 4, 24, 10, 4, 3
        q = _rand((2 + 5, nh, D), 14)
        pool = _rand((1, P, psz, D), 15)
        seq_start = np.asarray([0, 1, 2], np.int32)
        num_tokens = np.asarray([1, 0, 5], np.int32)
        kv_lengths = np.asarray([6, 0, 9], np.int32)
        tables = np.asarray([[3, 4, 0], [0, 0, 0], [5, 6, 7]], np.int32)
        with jx.jax.default_matmul_precision("highest"):
            want = np.asarray(jx.ragged.ragged_paged_attention(
                *map(jx.jnp.asarray, (q, pool, pool, seq_start, num_tokens,
                                      kv_lengths, tables)), scale=0.2))
        tp = _t(pool)
        got = ops.ragged_paged_attention(
            _t(q), tp, tp, *map(_t, (seq_start, num_tokens, kv_lengths,
                                     tables)), scale=0.2)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
        ref = ragged_attention_reference(
            _t(q), tp, tp, *map(_t, (seq_start, num_tokens, kv_lengths,
                                     tables)), scale=0.2)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


# --------------------------------------------------------------- models
PROMPTS = np.random.RandomState(3).randint(0, 512, (2, 7)).astype(np.int32)


@pytest.fixture(scope="module")
def models(jx):
    """{"qlora" / "plain": (JAX model, port model)}: seeded tiny JAX
    models (with and without q-lora) and the port's on their weights."""
    from paddle_tpu_torch.convert import load_reference_state
    from paddle_tpu_torch.models import (DeepSeekV2ForCausalLM,
                                         deepseek_v2_tiny_config)
    out = {}
    for name, ql in (("qlora", 32), ("plain", None)):
        jx.paddle.seed(0)
        jm = jx.ds.DeepSeekV2ForCausalLM(jx.ds.deepseek_v2_tiny_config(
            moe_dropless=True, q_lora_rank=ql))
        jm.eval()
        state = {k: np.asarray(v) for k, v in jx.extract_state(jm).items()}
        tm = DeepSeekV2ForCausalLM(deepseek_v2_tiny_config(
            moe_dropless=True, q_lora_rank=ql), device="cpu")
        assert set(tm.state_dict()) == set(state)
        load_reference_state(tm, state)
        out[name] = (jm, tm)
    return out


@pytest.fixture(scope="module")
def jax_forward(jx, models):
    """{name: f(ids) -> logits}: each JAX model's forward as one compiled
    program (op by op, eager JAX compiles every op), shared by the logits
    test and `generate` (whose buffer has the same shape)."""
    out = {}
    for name, (jm, _) in models.items():
        def pure(state, ids, jm=jm):
            with jx.StateSwap([jm]):
                jx.bind_state(jm, state)
                return type(jm).forward(jm, jx.Tensor(ids))._data

        program, state = jx.jax.jit(pure), jx.extract_state(jm)

        def forward(ids, program=program, state=state):
            with jx.jax.default_matmul_precision("highest"):
                return program(state, jx.jnp.asarray(ids))
        out[name] = forward
    return out


def _same_tree(jp, tp):
    """Two decode trees hold the same leaves, byte for byte."""
    skip = {"cfg", "family", "layers", "cos", "sin", "moe_static"}

    def same(a, b, where):
        assert set(b) == set(a), where
        for k in b:
            if isinstance(b[k], dict):
                same(a[k], b[k], f"{where}.{k}")
            elif b[k] is None:
                assert a[k] is None, (where, k)
            else:
                want = np.asarray(a[k])
                got = b[k].numpy()
                assert got.dtype == want.dtype, (where, k)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{where}.{k}")

    same({k: v for k, v in jp.items() if k not in skip},
         {k: v for k, v in tp.items() if k not in skip}, "tree")
    for i, (a, b) in enumerate(zip(jp["layers"], tp["layers"])):
        same(a, b, f"layers.{i}")


@pytest.fixture(scope="module")
def jax_cached(jx, models):
    """{impl: (tokens, scores)} of the JAX generate_cached on the plain
    model under each FLAGS_mla_decode_impl. JAX's "auto" at the tiny rank
    16 (its gate wants r % 128 == 0) takes the "xla" route, so one run
    serves both."""
    jm = models["plain"][0]
    cfg = jm.config
    assert not jx.mla.mla_kernel_eligible(
        cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim)
    xla = _jax_gen(jx, jx.gen.generate_cached, jm, PROMPTS, "xla")
    return {"fused": _jax_gen(jx, jx.gen.generate_cached, jm, PROMPTS,
                              "fused"), "xla": xla, "auto": xla}


def _jax_gen(jx, fn, jm, ids, impl="auto", **kw):
    with jx.jax.default_matmul_precision("highest"), jx.flags(
            mla_decode_impl=impl):
        gen, sc = fn(jm, jx.paddle.to_tensor(ids), max_new_tokens=NEW,
                     decode_strategy="greedy_search", **kw)
    return np.asarray(gen._data), np.asarray(sc._data)


class TestModelAgainstJax:
    @pytest.mark.parametrize("name", ["qlora", "plain"])
    def test_logits_match_jax(self, models, jax_forward, name):
        """The forward with q-lora (q_a -> norm -> q_b) and without it
        (q_proj), attention through `sdpa_padded_heads` (q / k 24 and v 16
        padded to the flash route's 64) once a layer. The ids have
        generate's buffer shape, so the compiled JAX forward is shared."""
        from paddle_tpu_torch.ops import flash_attention as attn_routes
        _, tm = models[name]
        ids = np.random.RandomState(5).randint(
            0, 512, (2, PROMPTS.shape[1] + NEW)).astype(np.int32)
        want = np.asarray(jax_forward[name](ids))
        attn_routes.reset_route_counts()
        with torch.no_grad():
            got = tm(torch.from_numpy(ids).long())
        assert attn_routes.route_counts["flash"] == 2
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


class TestGenerationAgainstJax:
    def test_generate_tokens_identical(self, jx, models, jax_forward):
        jm, tm = models["qlora"]
        jm.forward = lambda ids: jx.Tensor(jax_forward["qlora"](ids._data))
        try:
            want, _ = _jax_gen(jx, jx.gen.generate, jm, PROMPTS)
        finally:
            del jm.forward
        gen, _ = tgen.generate(tm, PROMPTS, max_new_tokens=NEW,
                               decode_strategy="greedy_search")
        np.testing.assert_array_equal(gen.numpy(), want)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_generate_cached_tokens_identical(self, jx, models, jax_cached,
                                              impl):
        _, tm = models["plain"]
        want, want_sc = jax_cached[impl]
        ops.reset_counts()
        tgen.mla_decode_composite.calls = 0
        with flags_guard(mla_decode_impl=impl):
            gen, sc = tgen.generate_cached(tm, PROMPTS, max_new_tokens=NEW,
                                           decode_strategy="greedy_search")
        np.testing.assert_array_equal(gen.numpy(), want)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-5)
        c = ops.launch_counts()
        # the kernel (its plain version here) once a layer a decode step
        # under "fused"; "auto" takes the composite at the tiny rank 16
        # (on CPU tensors only: on the card it raises)
        steps = 2 * (NEW - 1)
        fused = impl == "fused"
        assert c["mla_decode_attention"]["plain_calls"] == steps * fused
        assert tgen.mla_decode_composite.calls == steps * (not fused)
        assert c["flash_sdpa"]["plain_calls"] == 2     # the prefill

    def test_auto_on_the_card_refuses_an_ineligible_shape(self, models):
        # the tiny rank 16 fails mla_kernel_eligible: "auto" names the
        # gate instead of running the composite on a CUDA device; "xla"
        # asks for the composite and gets it
        cfg = models["plain"][1].config
        with flags_guard(mla_decode_impl="auto"), pytest.raises(
                ValueError, match="mla_kernel_eligible"):
            tgen._mla_cached_step_body(cfg, 16, device=torch.device("cuda"))
        with flags_guard(mla_decode_impl="xla"):
            tgen._mla_cached_step_body(cfg, 16, device=torch.device("cuda"))

    @pytest.mark.parametrize("name", ["qlora", "plain"])
    def test_decode_tree_byte_identical(self, jx, models, name):
        jm, tm = models[name]
        jp, tp = jx.gen._decode_params(jm), tgen._decode_params(tm)
        assert tp["family"] == jp["family"] == "mla"
        assert tp["moe_static"] == jp["moe_static"]
        _same_tree(jp, tp)

    @pytest.mark.parametrize("run", QUANT)
    def test_quantized_tree_byte_identical(self, engine_runs, run):
        """The int8 and int4 trees as the engines hold them (each JAX
        weight quantization costs seconds, so the engine runs' trees are
        the ones compared): int8 on the plain model with wq | wkva
        concatenated into the fused front's ``wqkva`` slab, int4 on the
        q-lora model (the split front: every leaf as `_mla_decode_params`
        makes it, kv_b packed for its whole read)."""
        r = engine_runs[run]
        _same_tree(r["jeng"]._p, r["teng"]._p)
        L = r["teng"]._p["layers"][0]
        if run == "int8":
            assert L["wqkva_q"].dtype == torch.int8 and "wq_q" not in L
        else:
            assert tuple(L["wkvb_q4"].shape) == (8, 128)   # [r / 2, N]
            assert "wqa_q4" in L and "wqb_q4" in L

    @pytest.mark.parametrize("quant", QUANT)
    def test_generate_cached_quantized(self, engine_runs, models, quant):
        """Each request of the trace alone through the quantized
        generate_cached gives the JAX engine's tokens under that layout
        (the JAX engine's requests equal its solo generate_cached)."""
        r = engine_runs[quant]
        _, tm = models[RUNS[quant][0]]
        ops.reset_counts()
        for rid, (prompt, max_new, _) in enumerate(r["trace"]):
            gen, _ = tgen.generate_cached(
                tm, prompt[None], max_new_tokens=max_new,
                decode_strategy="greedy_search", weight_only_quant=quant)
            np.testing.assert_array_equal(gen[0].numpy(), r["jres"][rid])
        c = ops.launch_counts()
        # int4 reads kv_b whole through int4_dequantize, once a layer a step
        steps = sum(m for _, m, _ in r["trace"])
        assert c["int4_dequantize"]["plain_calls"] == \
            (2 * steps if quant == "int4" else 0)


# --------------------------------------------------------------- engine
ENGINE_KW = dict(max_slots=2, page_size=4, prefill_chunk=6)
#: run -> (model, port engine kwargs, JAX engine kwargs)
RUNS = {
    "fused": ("plain", {}, {}),
    "split": ("qlora", dict(megafront=False, megadecode=False),
              dict(megafront=False, megadecode=False)),
    "int8": ("plain", dict(weight_only_quant="int8"),
             dict(weight_only_quant="int8")),
    "int4": ("qlora", dict(weight_only_quant="int4"),
             dict(weight_only_quant="int4")),
}


def _engine_trace(V):
    """Three requests sharing a prefix (the second and third join while
    the first decodes and fork its pages), then a seeded one."""
    rng = np.random.RandomState(11)
    a = rng.randint(0, V, 9).astype(np.int32)
    tail = rng.randint(0, V, 3).astype(np.int32)
    return [(a, 4, 0), (np.concatenate([a, tail]), 3, 2),
            (np.concatenate([a[:6], tail[:2]]), 3, 3),
            (rng.randint(0, V, 11).astype(np.int32), 2, 4)]


@pytest.fixture(scope="module")
def engine_runs(jx, models):
    from paddle_tpu_torch.serving import ServingEngine
    from test_torch_llama_serving import _drive
    trace = _engine_trace(512)
    out = {}
    for run, (name, tkw, jkw) in RUNS.items():
        jm, tm = models[name]
        jeng = jx.Engine(jm, enable_prefix_cache=False, **jkw, **ENGINE_KW)
        with jx.jax.default_matmul_precision("highest"):
            jres, _ = _drive(jeng, trace)
        ops.reset_counts()
        teng = ServingEngine(tm, device="cpu", **tkw, **ENGINE_KW)
        tres, _ = _drive(teng, trace)
        out[run] = dict(jres=jres, tres=tres, teng=teng, jeng=jeng,
                        counts=ops.launch_counts(), trace=trace)
    return out


class TestEngineAgainstJax:
    @pytest.mark.parametrize("run", list(RUNS))
    def test_greedy_tokens_identical(self, engine_runs, run):
        r = engine_runs[run]
        assert set(r["tres"]) == set(r["jres"]) == set(range(len(r["trace"])))
        for rid, ref in r["jres"].items():
            np.testing.assert_array_equal(r["tres"][rid], ref)

    @pytest.mark.parametrize("run", list(RUNS))
    def test_plain_calls_per_layer_per_step(self, engine_runs, run):
        r = engine_runs[run]
        eng, c = r["teng"], r["counts"]
        n, layers = eng.launches, 2
        jeng = r["jeng"]
        fused = run in ("fused", "int8")
        assert eng.megafront == jeng.megafront == fused
        assert eng.front_half_launches == jeng.front_half_launches == \
            {"fused": 2, "int8": 2, "split": 7, "int4": 7}[run]
        assert eng.megadecode == jeng.megadecode == (run != "split")
        per_step = lambda name: c[name]["plain_calls"] / n  # noqa: E731
        assert per_step("fused_qkv_rope_append") == layers * fused
        assert per_step("fused_append_rows") == layers * (not fused)
        assert per_step("ragged_paged_attention") == layers
        assert per_step("int4_dequantize") == layers * (run == "int4")
        # norms: ln1 and the final one, plus on the split front the
        # latent's (and q-lora's), plus ln2 without the fused back half
        norms = {"fused": 1, "int8": 1, "int4": 3, "split": 4}[run]
        assert per_step("fused_rms_norm") == layers * norms + 1
        assert sum(v["launches"] for v in c.values()) == 0

    def test_alternating_path_names_its_item(self, models):
        from paddle_tpu_torch.serving import ServingEngine
        _, tm = models["plain"]
        with pytest.raises(NotImplementedError,
                           match="queue A item 5c's rest"):
            ServingEngine(tm, device="cpu", ragged=False)

    def test_flash_backward_refuses_head_dim_192(self):
        from paddle_tpu_torch.ops import flash_sdpa_bwd
        q = torch.zeros(1, 4, 1, 192)
        with pytest.raises(ValueError, match="queue A item 5c's rest"):
            flash_sdpa_bwd(q, q, q, q, torch.zeros(1, 1, 4), q)


# ------------------------------------------------------------ on the card
def rel_errors(got, want):
    """(tensor, row) relative errors of `got` against `want` over rows of
    the last axis, each row's norm floored at 1% of the rms row norm."""
    w = want.float().reshape(-1, want.shape[-1])
    d = got.float().reshape(-1, want.shape[-1]) - w
    wn, dn = w.norm(dim=-1), d.norm(dim=-1)
    floor = 1e-2 * float(w.norm()) / wn.numel() ** 0.5
    return (float(d.norm() / w.norm()),
            float((dn / wn.clamp_min(floor)).max()))


#: chip_smoke.py's MLA_BF16_LIMITS (readings of the sound kernels and of
#: planted faults: quant_limits.py)
MLA_BF16_LIMITS = {"mla_decode_attention": (1.2e-3, 6e-3),
                   "fused_qkv_rope_append_mla": (3e-4, 1e-3),
                   "ragged_576": (5e-3, 1e-2), "flash_192": (1e-2, 3e-2)}
#: bf16 (tensor, row) limits of mla_decode_attention at the edge shapes
#: (latent widths 32-256, 2-32 heads, lengths 0 / 1 / 17 / 700): the bf16
#: kernel rounds p against each 16-row split's running maximum, the plain
#: version against the sequence's, and with few or flat scores more of
#: the output rests on rows rounded apart (up to 2.1e-3 / 4.1e-3 read at
#: such shapes; readings in PERF.md); a dead row staged, a dead split
#: merged or a stored padding head read non-finite or O(1)
MLA_EDGE_LIMITS = (5e-3, 1.5e-2)
#: the share of bf16 outputs of mla_decode_attention that may differ from
#: the plain version's where both round p against the same maximum (one
#: tile a split): sound and planted readings in PERF.md (quant_limits.py)
MLA_P_ROUNDING_DIFFER = 0.01


@pytest.mark.cuda
class TestMlaOnCard:
    """The new kernels against their plain versions on the card, at
    DeepSeek-V2-Lite's shapes: mla_decode_attention (4 x 544 and 8 x
    8192 cache rows, NaN past the lengths), fused_append_rows,
    int4_dequantize (kv_b [512, 4096] and an odd N), the MLA site of
    fused_qkv_rope_append (fp, int8), ragged attention at one latent
    head of 576 (rep 16) and flash forward at head dim 192."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are CUDA C++ with "
                        "no CPU mode")
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("B,T", [(4, 544), (8, 8192)])
    def test_mla_decode(self, dtype, B, T):
        g = torch.Generator(device="cuda").manual_seed(0)
        nh, r, dr = 16, 512, 64
        rnd = lambda *s: torch.randn(*s, device="cuda",  # noqa: E731
                                     generator=g).to(dtype)
        qe, qp, cl, cp = rnd(B, nh, r), rnd(B, nh, dr), rnd(B, T, r), \
            rnd(B, T, dr)
        lens = torch.randint(1, T + 1, (B,), device="cuda", generator=g,
                             dtype=torch.int32)
        lens[0] = 1
        dead = torch.arange(T, device="cuda")[None] >= lens[:, None].long()
        cl[dead] = float("nan")
        cp[dead] = float("nan")
        before = mla_decode_attention.launches
        got = mla_decode_attention(qe, qp, cl, cp, lens, scale=192 ** -0.5)
        torch.cuda.synchronize()
        assert mla_decode_attention.launches == before + 1
        want = mla_decode_reference(qe, qp, cl, cp, lens, scale=192 ** -0.5)
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        else:
            t, rw = rel_errors(got, want)
            lim = MLA_BF16_LIMITS["mla_decode_attention"]
            assert t < lim[0] and rw < lim[1], (t, rw)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nh,r,dr", [(2, 512, 64), (4, 128, 32),
                                         (32, 512, 64), (6, 32, 32)])
    def test_mla_decode_heads_and_dead_splits(self, dtype, nh, r, dr):
        # head tiles of 2 / 4 / 6 live heads and two m16 tiles (32), every
        # latent width build; a sequence of length 0 (zeros), one of 1, one
        # of 17 (every split past the second wholly dead), one full
        g = torch.Generator(device="cuda").manual_seed(nh + r)
        B, T = 4, 700
        rnd = lambda *s: torch.randn(*s, device="cuda",  # noqa: E731
                                     generator=g).to(dtype)
        qe, qp, cl, cp = rnd(B, nh, r), rnd(B, nh, dr), rnd(B, T, r), \
            rnd(B, T, dr)
        lens = torch.tensor([0, 1, 17, T], device="cuda", dtype=torch.int32)
        dead = torch.arange(T, device="cuda")[None] >= lens[:, None].long()
        cl[dead] = float("nan")
        cp[dead] = float("nan")
        got = mla_decode_attention(qe, qp, cl, cp, lens, scale=0.07)
        torch.cuda.synchronize()
        want = mla_decode_reference(qe, qp, cl, cp, lens, scale=0.07)
        assert bool(torch.isfinite(got).all())
        assert bool((got[0] == 0).all())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        else:
            t, rw = rel_errors(got[1:], want[1:])
            assert t < MLA_EDGE_LIMITS[0] and rw < MLA_EDGE_LIMITS[1], (t, rw)

    def test_mla_decode_rounds_p_as_the_plain_version(self):
        # one 16-row tile and one split a sequence: the bf16 kernel rounds
        # p = exp(s - m) to bf16 against the same maximum as the plain
        # version, so the two differ by summation order only and agree on
        # nearly every output; p carried unrounded into the product moves
        # the outputs by less than a bf16 step, which the relative bars
        # cannot see, but flips the rounding of many of them
        g = torch.Generator(device="cuda").manual_seed(3)
        B, T, nh, r, dr = 8, 16, 16, 512, 64
        rnd = lambda *s: torch.randn(*s, device="cuda",  # noqa: E731
                                     generator=g).to(torch.bfloat16)
        qe, qp, cl, cp = rnd(B, nh, r), rnd(B, nh, dr), rnd(B, T, r), \
            rnd(B, T, dr)
        lens = torch.full((B,), T, device="cuda", dtype=torch.int32)
        got = mla_decode_attention(qe, qp, cl, cp, lens, scale=192 ** -0.5)
        torch.cuda.synchronize()
        want = mla_decode_reference(qe, qp, cl, cp, lens, scale=192 ** -0.5)
        differ = float((got.float() != want.float()).float().mean())
        assert differ <= MLA_P_ROUNDING_DIFFER, differ

    def test_append_rows_and_int4_dequantize(self):
        g = torch.Generator(device="cuda").manual_seed(1)
        pages = torch.randn(1, 40, 16, 576, device="cuda", generator=g)\
            .bfloat16()
        rows = torch.randn(132, 1, 576, device="cuda", generator=g)\
            .bfloat16()
        # distinct live slots (a repeated one would hold either row)
        slot = torch.randperm(39 * 16, device="cuda", generator=g)[:132]
        page, off = slot // 16 + 1, slot % 16
        page[:5] = 0
        want = append_rows_reference(pages.clone(), rows, page, off)
        got = fused_append_rows(pages, rows, page, off)
        torch.cuda.synchronize()
        assert got is pages
        live = page != 0
        torch.testing.assert_close(got[0, page[live], off[live]],
                                   want[0, page[live], off[live]],
                                   rtol=0, atol=0)
        for K, N in ((512, 4096), (64, 37)):
            w = torch.randn(K, N, device="cuda", generator=g)
            qw, s = weight_quantize(w, "weight_only_int4")
            got = int4_dequantize(qw, s)
            torch.cuda.synchronize()
            want = int4_dequantize(qw.cpu(), s.cpu())
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("algo", [None, "weight_only_int8"])
    def test_mla_site(self, dtype, algo):
        g = torch.Generator(device="cuda").manual_seed(2)
        T, H, nh, dn, dr, r, P, psz = 132, 2048, 16, 128, 64, 512, 40, 16
        N = nh * (dn + dr) + r + dr
        h = torch.randn(T, H, device="cuda", generator=g).to(dtype)
        w = (0.02 * torch.randn(H, N, device="cuda", generator=g))
        gw = 1 + 0.1 * torch.randn(r, device="cuda", generator=g)
        if algo:
            w, s = weight_quantize(w, algo)
        else:
            w, s = w.to(dtype), None
        ang = torch.rand(T, dr // 2, device="cuda", generator=g) * 6
        cos, sin = ang.cos(), ang.sin()
        page = torch.arange(T, device="cuda") // psz + 1
        off = torch.arange(T, device="cuda") % psz
        pool = torch.zeros(1, P, psz, r + dr, device="cuda", dtype=dtype)
        kw = dict(heads=nh, algo=algo, eps=1e-6, nope_dim=dn, rope_dim=dr,
                  lora_rank=r, norm_weight=gw)
        q, _ = fused_qkv_rope_append(h, w, s, None, cos, sin, pool, None,
                                     page, off, **kw)
        torch.cuda.synchronize()
        ref_pool = torch.zeros_like(pool)
        qr, _ = qkv_rope_append_reference(h, w, s, None, cos, sin, ref_pool,
                                          None, page, off, **kw)
        if dtype == torch.float32:
            torch.testing.assert_close(q, qr, atol=2e-5, rtol=2e-5)
            torch.testing.assert_close(pool, ref_pool, atol=2e-5, rtol=2e-5)
        else:
            # a row per token: its q heads and its pool row
            lim = MLA_BF16_LIMITS["fused_qkv_rope_append_mla"]
            t, rw = rel_errors(
                torch.cat([q.reshape(T, -1), pool[0, page, off]], 1),
                torch.cat([qr.reshape(T, -1), ref_pool[0, page, off]], 1))
            assert t < lim[0] and rw < lim[1], (t, rw)

    @pytest.mark.parametrize("same", [True, False])
    @pytest.mark.parametrize("psz", [8, 16])
    def test_ragged_576_splits(self, psz, same):
        # the latent row's bf16 kernel at lengths 1, 15, 16, 17, 1023 and
        # 8192 (keys across many splits), an idle slot and a 96-token
        # chunk, NaN in every pool row past a length and every page no
        # table names, one pool as K and V (the engine's) and two: within
        # the ragged_576 limits of the plain version on the clean pools
        from test_torch_ops import _ragged_batch
        args, clean = _ragged_batch([1, 15, 16, 17, 1023, 8192, 0, 200],
                                    [1, 1, 1, 1, 1, 1, 0, 96], 16, 1, 576,
                                    psz, seed=6, same=same, poison=True)
        scale = 192 ** -0.5
        got = ops.ragged_paged_attention(*args, scale=scale)
        torch.cuda.synchronize()
        want = ragged_attention_reference(*clean, scale=scale)
        assert torch.isfinite(got.float()).all()
        live = torch.arange(102, device="cuda")
        assert float(got[102:].float().abs().sum()) == 0.0
        t, rw = rel_errors(got[live], want[live])
        lim = MLA_BF16_LIMITS["ragged_576"]
        assert t < lim[0] and rw < lim[1], (t, rw)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ragged_576_and_flash_192(self, dtype):
        g = torch.Generator(device="cuda").manual_seed(3)
        psz, P, nj = 16, 80, 20
        pool = torch.randn(1, P, psz, 576, device="cuda",
                           generator=g).to(dtype)
        q = torch.randn(4 + 128, 16, 576, device="cuda", generator=g)\
            .to(dtype)
        ss = torch.arange(5, dtype=torch.int32, device="cuda")
        nt = torch.tensor([1, 1, 0, 1, 128], dtype=torch.int32,
                          device="cuda")
        kvl = torch.tensor([300, 17, 0, 64, 200], dtype=torch.int32,
                           device="cuda")
        tab = torch.randint(1, P, (5, nj), device="cuda", generator=g,
                            dtype=torch.int32)
        scale = 192 ** -0.5
        got = ops.ragged_paged_attention(q, pool, pool, ss, nt, kvl, tab,
                                         scale=scale)
        torch.cuda.synchronize()
        want = ragged_attention_reference(q, pool, pool, ss, nt, kvl, tab,
                                          scale=scale)
        live = torch.cat([torch.arange(2), torch.tensor([3]),
                          torch.arange(4, 132)]).cuda()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        else:
            t, rw = rel_errors(got[live], want[live])
            lim = MLA_BF16_LIMITS["ragged_576"]
            assert t < lim[0] and rw < lim[1], (t, rw)
        from paddle_tpu_torch.ops.flash import flash_sdpa, \
            flash_sdpa_reference
        S = 1024 if dtype == torch.float32 else 4096
        qf, kf, vf = (torch.randn(1, S, 4, 192, device="cuda", generator=g)
                      .to(dtype) for _ in range(3))
        got = flash_sdpa(qf, kf, vf, causal=True)
        torch.cuda.synchronize()
        want = flash_sdpa_reference(qf, kf, vf, causal=True)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        else:
            t, rw = rel_errors(got, want)
            lim = MLA_BF16_LIMITS["flash_192"]
            assert t < lim[0] and rw < lim[1], (t, rw)
