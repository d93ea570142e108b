"""The port's MoE slice against the JAX package on the CPU.

- `gmm` on CPU tensors (its plain version `gmm_plain`) against the JAX
  Pallas kernel (interpret mode on the CPU, as tests/test_gmm_kernel.py
  runs it) and `gmm_reference`: K 128, N 128 / 256, uneven sizes with
  empty groups, one group holding every row, a sum short of M (its tail
  rows exactly zero); f32 within 1e-5, bf16 within 2e-2;
- `grouped_gemm` is `gmm` under both names of FLAGS_gmm_impl, the JAX
  package's other routes ("einsum", "xla", "bundled") are refused;
  `sort_by_group` against numpy;
- `dense_expert_ffn` against `dropless_expert_ffn` at T in {8, 32, 33,
  64} (within 1e-6, the JAX package's own bar), each against its JAX
  counterpart (1e-5);
- the models: state keys equal `extract_state`'s, forward logits within
  2e-5 and the aux loss of qwen2_moe_tiny_config(moe_dropless=True,
  first_k_dense_replace=1) and ernie45_moe_config(), each in the
  capacity and in the dropless forward;
- generation: greedy tokens of `generate` (both forwards) and of
  `generate_cached` (fp) identical to JAX's, scores within 1e-5; the
  decode trees byte for byte in the fp, int8 and int4 layouts; the
  capacity-mode warning;
- `ServingEngine` against the JAX engine on one seeded trace with
  T = max_slots + prefill_chunk = 38 > 32 rows, so every unified step
  routes dropless through `gmm` (3 a routed layer a step) and the
  alternating path's prefill chunks too, its decode launches (2 rows)
  through the dense experts: fp on the fused chain, the split chain and
  the alternating path, each against the JAX engine on that path; int8
  and int4 on all three paths, each against the JAX engine on the
  alternating path with the same layout (one JAX engine a layout keeps
  the file cheap; the JAX engine gives one answer on every path on the
  CPU); quantized generate_cached, request by request, against the
  same JAX engine's tokens.

All in f32 (a flipped router top-k is a different program, not a
rounding error), JAX at "highest" matmul precision.

`TestGmmOnCard` holds the CUDA kernel against `gmm_plain` on the card
at the serving shapes of ERNIE-4.5-21B-A3B (M 792 over 64 experts,
[2560 -> 1536] and [1536 -> 2560]), its prefill (M 12288) and the edge
cases, the backward kernels (dlhs, tgmm) against their plain versions at
the training routing (M 24576) and the edge cases, and a MoELayer's
gradients on the card against the CPU; it skips without
a card. On the machine with the card, which has no JAX: python -m pytest
--noconftest tests/test_torch_moe.py -m cuda. bf16 is held by relative
errors over the output and over each row (limits 3e-4 / 2e-3: both
round an f32 sum of exact bf16 products once, and differ in summation
order only; the edge cases by the first alone, within 5e-4), f32
within 2e-5.
"""

import contextlib
import copy
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import ops
from paddle_tpu_torch.flags import flags_guard, set_flags
from paddle_tpu_torch.incubate.moe import (dense_expert_ffn,
                                           dropless_expert_ffn)
from paddle_tpu_torch.ops.gmm import (gmm, gmm_dlhs, gmm_plain, tgmm,
                                      tgmm_plain)
from paddle_tpu_torch.ops.grouped_gemm import grouped_gemm, sort_by_group

#: chip_smoke.py's GMM_BF16_LIMITS and GMM_EDGE_TENSOR_LIMIT (readings of
#: the sound kernel and of planted faults: gmm_limits.py)
BF16_TENSOR_LIMIT = 3e-4
BF16_ROW_LIMIT = 2e-3
BF16_EDGE_TENSOR_LIMIT = 5e-4
#: chip_smoke.py's GMM_BWD_BF16_LIMITS and GMM_BWD_EDGE_TENSOR_LIMIT for
#: gmm's backward kernels (gmm_limits.py)
BWD_BF16_TENSOR_LIMIT = 3e-4
BWD_BF16_ROW_LIMIT = 2e-3
BWD_BF16_EDGE_TENSOR_LIMIT = 5e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only class runs on a
    machine without JAX."""
    jax = pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu import generation as jgen
    from paddle_tpu.incubate import moe as jmoe
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.jit import _StateSwap, bind_state, extract_state
    from paddle_tpu.models import ernie as jernie
    from paddle_tpu.models import moe_llm as jmoe_llm
    from paddle_tpu.ops import pallas_gmm, references
    from paddle_tpu.serving import ServingEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, paddle=paddle, gen=jgen, moe=jmoe,
        Tensor=Tensor, StateSwap=_StateSwap, bind_state=bind_state,
        extract_state=extract_state, ernie=jernie, moe_llm=jmoe_llm,
        gmm=pallas_gmm.gmm, gmm_reference=references.gmm_reference,
        Engine=ServingEngine)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _gmm_case(M, K, N, sizes, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32),
            (0.1 * rng.randn(len(sizes), K, N)).astype(np.float32),
            np.asarray(sizes, np.int32))


def rel_errors(got, want):
    """(tensor, row) relative errors of `got` against `want` [M, N], each
    row's norm floored at 1% of the root-mean-square row norm."""
    w = want.float()
    d = got.float() - w
    wn, dn = w.norm(dim=-1), d.norm(dim=-1)
    floor = 1e-2 * float(w.norm()) / wn.numel() ** 0.5
    return (float(d.norm() / w.norm()),
            float((dn / wn.clamp_min(floor)).max()))


# ------------------------------------------------------------------ gmm
GMM_CASES = [
    (260, 128, 256, [60, 0, 100, 70, 30], torch.float32),  # uneven groups
    (300, 128, 128, [0, 120, 0, 150], torch.float32),      # empties, tail 30
    (256, 128, 256, [0, 256, 0], torch.bfloat16),          # one group, all
]


class TestGmmParity:
    @pytest.mark.parametrize("M,K,N,sizes,dtype", GMM_CASES)
    def test_plain_matches_jax_kernel_and_reference(self, jx, M, K, N,
                                                    sizes, dtype):
        lhs, rhs, gs = _gmm_case(M, K, N, sizes)
        jdt = jx.jnp.float32 if dtype == torch.float32 else jx.jnp.bfloat16
        jl, jr = jx.jnp.asarray(lhs, jdt), jx.jnp.asarray(rhs, jdt)
        with jx.jax.default_matmul_precision("highest"):
            want_k, want_r = (np.asarray(w, np.float32) for w in jx.jax.jit(
                lambda *a: (jx.gmm(*a), jx.gmm_reference(*a)))(
                    jl, jr, jx.jnp.asarray(gs)))
        before = dict(launches=gmm.launches, plain=gmm.plain_calls)
        out = gmm(_t(lhs).to(dtype), _t(rhs).to(dtype), _t(gs))
        assert out.dtype == dtype and tuple(out.shape) == (M, N)
        assert gmm.plain_calls == before["plain"] + 1
        assert gmm.launches == before["launches"]
        for impl in ("auto", "intree"):    # the flag's two names of gmm
            with flags_guard(gmm_impl=impl):
                routed = grouped_gemm(_t(lhs).to(dtype), _t(rhs).to(dtype),
                                      _t(gs))
            torch.testing.assert_close(routed, out, rtol=0, atol=0)
        got = out.float().numpy()
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        for want in (want_k, want_r):
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        tail = sum(sizes)
        np.testing.assert_array_equal(got[tail:], 0.0)
        if tail < M:
            np.testing.assert_array_equal(want_k[tail:], 0.0)

    def test_plain_is_differentiable_on_the_cpu(self):
        lhs, rhs, gs = _gmm_case(40, 16, 24, [10, 0, 25])
        x = _t(lhs).requires_grad_()
        w = _t(rhs).requires_grad_()
        gmm(x, w, _t(gs)).square().sum().backward()
        want = torch.zeros(40, 24)
        want[:10] = x.detach()[:10] @ w.detach()[0]
        want[10:35] = x.detach()[10:35] @ w.detach()[2]
        np.testing.assert_allclose(x.grad[35:].numpy(), 0.0)
        np.testing.assert_allclose(w.grad[1].numpy(), 0.0)
        np.testing.assert_allclose(
            w.grad[2].numpy(), (2 * x.detach()[10:35].T @ want[10:35])
            .numpy(), rtol=1e-5, atol=1e-5)

    def test_shape_checks(self):
        lhs, rhs, gs = _gmm_case(8, 16, 24, [4, 4])
        with pytest.raises(ValueError, match="do not agree"):
            gmm(_t(lhs)[:, :8], _t(rhs), _t(gs))
        with pytest.raises(TypeError, match="int32/int64"):
            gmm(_t(lhs), _t(rhs), _t(gs).float())


class TestGroupedGemmRouting:
    @pytest.mark.parametrize("impl,names", [("einsum", "gmm_plain"),
                                            ("xla", "ragged_dot"),
                                            ("bundled", "megablox")])
    def test_jax_only_routes_raise(self, impl, names):
        with pytest.raises(ValueError, match=names):
            set_flags({"FLAGS_gmm_impl": impl})
        with pytest.raises(ValueError, match="invalid value"):
            set_flags({"FLAGS_gmm_impl": "fast"})

    def test_sort_by_group(self):
        ids = np.random.RandomState(1).randint(0, 5, 23)
        x = torch.arange(23.0)[:, None]
        srt, sizes, inv = sort_by_group(x, _t(ids), 6)
        order = np.argsort(ids, kind="stable")
        np.testing.assert_array_equal(srt[:, 0].numpy(), order)
        np.testing.assert_array_equal(sizes.numpy(),
                                      np.bincount(ids, minlength=6))
        assert sizes.dtype == torch.int32
        np.testing.assert_array_equal(srt[inv].numpy(), x.numpy())


# ------------------------------------------------ dense vs dropless FFN
def _ffn_case(T, H=64, I=32, E=4):
    rng = np.random.RandomState(T)
    logits = rng.randn(T, E).astype(np.float32)
    gates = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (rng.randn(T, H).astype(np.float32), gates.astype(np.float32),
            *[(0.1 * rng.randn(*s)).astype(np.float32)
              for s in ((E, H, I), (E, H, I), (E, I, H))])


class TestDenseVsDroplessFFN:
    @pytest.mark.parametrize("T", [8, 32, 33, 64])
    def test_equal_and_each_matches_jax(self, jx, T):
        case = _ffn_case(T)
        kw = dict(top_k=2, renormalize=True)
        yd, td = dense_expert_ffn(*map(_t, case), **kw)
        yg, tg = dropless_expert_ffn(*map(_t, case), **kw)
        np.testing.assert_array_equal(td.numpy(), tg.numpy())
        np.testing.assert_allclose(yd.numpy(), yg.numpy(), rtol=1e-6,
                                   atol=1e-6)
        jcase = [jx.jnp.asarray(a) for a in case]
        def both(*a):                        # one program, not op by op
            return (jx.moe.dense_expert_ffn(*a, **kw),
                    jx.moe.dropless_expert_ffn(*a, **kw))

        with jx.jax.default_matmul_precision("highest"):
            outs = jx.jax.jit(both)(*jcase)
        for (jy, jt), (y, ti) in zip(outs, ((yd, td), (yg, tg))):
            np.testing.assert_array_equal(ti.numpy(), np.asarray(jt))
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                       atol=1e-5)

    def test_ties_take_the_lower_expert_first(self):
        # lax.top_k's order; torch.topk fixes none among equal gates
        gates = torch.tensor([[0.2, 0.3, 0.3, 0.2]])
        x = torch.ones(1, 8)
        w = torch.zeros(4, 8, 8)
        _, topi = dense_expert_ffn(x, gates, w, w, w.transpose(1, 2),
                                   top_k=3, renormalize=True)
        np.testing.assert_array_equal(topi.numpy(), [[1, 2, 0]])


# --------------------------------------------------------------- models
CONFIGS = ("qwen2_moe_dropless", "ernie45")
PROMPTS = np.random.RandomState(3).randint(0, 512, (2, 20)).astype(np.int32)
NEW = 3
QUANT = (None, "int8", "int4")


@pytest.fixture(scope="module")
def models(jx):
    """{name: (JAX model, port model, state)}: the seeded tiny JAX models
    and the port's carrying their weights."""
    from paddle_tpu_torch.convert import load_reference_state
    from paddle_tpu_torch.models import (Ernie45MoEForCausalLM,
                                         MoEForCausalLM, ernie45_moe_config,
                                         qwen2_moe_tiny_config)
    kw = dict(moe_dropless=True, first_k_dense_replace=1)
    builds = {
        "qwen2_moe_dropless": (
            lambda: jx.moe_llm.MoEForCausalLM(
                jx.moe_llm.qwen2_moe_tiny_config(**kw)),
            lambda: MoEForCausalLM(qwen2_moe_tiny_config(**kw),
                                   device="cpu")),
        "ernie45": (
            lambda: jx.ernie.Ernie45MoEForCausalLM(
                jx.ernie.ernie45_moe_config()),
            lambda: Ernie45MoEForCausalLM(ernie45_moe_config(),
                                          device="cpu"))}
    out = {}
    for name, (jbuild, tbuild) in builds.items():
        jx.paddle.seed(0)
        jm = jbuild()
        jm.eval()
        state = {k: np.asarray(v) for k, v in jx.extract_state(jm).items()}
        tm = tbuild()
        load_reference_state(tm, state)
        out[name] = (jm, tm, state)
    return out


def _set_dropless(models, name, dropless: bool):
    """Switch every routed layer of both models to the dropless or the
    capacity forward."""
    jm, tm, _ = models[name]
    for model in (jm, tm):
        for lyr in model.model.layers:
            if hasattr(lyr.mlp, "dropless"):
                lyr.mlp.dropless = dropless


@contextlib.contextmanager
def _compiled_forward(jx, jm):
    """The JAX model's forward, the same function, run as one compiled
    program instead of op by op (eager JAX dispatches and compiles every
    op; a whole forward takes ~1 s of the CPU lane). Also returns the
    router aux loss of the call through ``jm.last_aux``."""
    def pure(state, ids):
        with jx.StateSwap([jm]):
            jx.bind_state(jm, state)
            out = type(jm).forward(jm, jx.Tensor(ids))
            return out._data, jm.model.aux_loss()._data

    program = jx.jax.jit(pure)
    state = jx.extract_state(jm)

    def forward(ids):
        logits, jm.last_aux = program(state, ids._data)
        return jx.Tensor(logits)

    jm.forward = forward
    try:
        yield jm
    finally:
        del jm.forward


def _jax_run(jx, fn, jm, ids, **kw):
    with jx.jax.default_matmul_precision("highest"):
        gen, sc = fn(jm, jx.paddle.to_tensor(ids), **kw)
    return np.asarray(gen._data), np.asarray(sc._data)


class TestModelAgainstJax:
    @pytest.mark.parametrize("name", CONFIGS)
    def test_state_keys(self, models, name):
        jm, tm, state = models[name]
        assert set(tm.state_dict()) == set(state)
        mlp = tm.model.layers[1].mlp
        assert tuple(mlp.w_up.shape) == tuple(
            state["model.layers.1.mlp.w_up"].shape)
        assert tm.model.layers[0].mlp.__class__.__name__ == "LlamaMLP"

    @pytest.mark.parametrize("dropless", [True, False])
    @pytest.mark.parametrize("name", CONFIGS)
    def test_forward_logits_and_aux(self, jx, models, name, dropless):
        jm, tm, _ = models[name]
        was = jm.model.layers[1].mlp.dropless
        _set_dropless(models, name, dropless)
        try:
            # generate's buffer shape, so both reuse JAX's compiled ops
            ids = (np.arange(2 * (7 + NEW), dtype=np.int32).reshape(
                2, 7 + NEW) * 37) % 512
            tids = torch.from_numpy(ids).long()
            with torch.no_grad():
                loss, logits = tm(tids, labels=tids)
            with jx.jax.default_matmul_precision("highest"), \
                    _compiled_forward(jx, jm):
                want = np.asarray(jm(jx.paddle.to_tensor(ids))._data)
                want_aux = float(jm.last_aux)
        finally:
            _set_dropless(models, name, was)
        np.testing.assert_allclose(logits.numpy(), want, atol=2e-5,
                                   rtol=2e-5)
        aux = tm.model.aux_loss()
        assert abs(float(aux) - want_aux) < 1e-6
        # the loss adds the router aux loss at aux_loss_weight
        from paddle_tpu_torch.distributed.parallel_layers import \
            ParallelCrossEntropy
        ce = ParallelCrossEntropy()(logits, tids).mean()
        torch.testing.assert_close(loss, ce + 0.01 * aux)


class TestGenerationAgainstJax:
    """On the dropless qwen2-MoE model: generate_cached's prefill has
    2 x 20 = 40 > 32 token rows (dropless, three gmm calls a routed
    layer), its decode steps 2 (every expert on every token)."""

    @pytest.mark.parametrize("dropless", [True, False])
    def test_generate_tokens_identical(self, jx, models, dropless):
        name = "qwen2_moe_dropless"
        jm, tm, _ = models[name]
        _set_dropless(models, name, dropless)
        try:
            kw = dict(max_new_tokens=NEW, decode_strategy="greedy_search")
            with _compiled_forward(jx, jm):
                want_gen, want_sc = _jax_run(jx, jx.gen.generate, jm,
                                             PROMPTS[:, :7], **kw)
            gen, sc = tgen.generate(tm, PROMPTS[:, :7], **kw)
        finally:
            _set_dropless(models, name, True)
        np.testing.assert_array_equal(gen.numpy(), want_gen)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-5)

    def test_generate_cached_tokens_identical(self, jx, models):
        jm, tm, _ = models["qwen2_moe_dropless"]
        kw = dict(max_new_tokens=NEW, decode_strategy="greedy_search")
        want_gen, want_sc = _jax_run(jx, jx.gen.generate_cached, jm,
                                     PROMPTS, **kw)
        ops.reset_counts()
        gen, sc = tgen.generate_cached(tm, PROMPTS, **kw)
        np.testing.assert_array_equal(gen.numpy(), want_gen)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-5)
        # one routed layer: three grouped GEMMs, in the prefill only
        assert ops.launch_counts()["gmm"] == {"launches": 0,
                                              "plain_calls": 3}

    @pytest.mark.parametrize("quant", QUANT[1:])
    def test_generate_cached_quantized(self, engine_runs, models, quant):
        """Each request of the serving trace alone through the quantized
        generate_cached gives the JAX engine's tokens under that layout
        (the JAX engine's requests equal its solo generate_cached, and a
        JAX generate_cached program a layout would cost a compile a
        prompt length); at PROMPTS, the prefill's 40 rows route dropless,
        with the int4 products through weight_only_linear."""
        _, tm, _ = models["qwen2_moe_dropless"]
        r = engine_runs[("alternating", quant)]
        for rid, (prompt, max_new, _) in enumerate(r["trace"]):
            gen, _ = tgen.generate_cached(
                tm, prompt[None], max_new_tokens=max_new,
                decode_strategy="greedy_search", weight_only_quant=quant)
            np.testing.assert_array_equal(gen[0].numpy(), r["jres"][rid])
        ops.reset_counts()
        tgen.generate_cached(tm, PROMPTS, max_new_tokens=NEW,
                             decode_strategy="greedy_search",
                             weight_only_quant=quant)
        counts = ops.launch_counts()
        assert counts["gmm"] == {"launches": 0, "plain_calls": 3}
        # int4 products: four projections a layer, the dense FFN's three
        # and the shared expert's three, the head (the prefill and NEW - 1
        # decode steps)
        wol = (4 * 2 + 3 + 3 + 1) * NEW if quant == "int4" else 0
        assert counts["weight_only_linear"] == {"launches": 0,
                                                "plain_calls": wol}

    @pytest.mark.parametrize("quant", QUANT)
    def test_decode_tree_byte_identical(self, jx, models, quant):
        jm, tm, _ = models["qwen2_moe_dropless"]
        jp = jx.gen._decode_params(jm, weight_only_quant=quant)
        tp = tgen._decode_params(tm, weight_only_quant=quant)
        assert tp["family"] == jp["family"] == "moe"
        assert tp["moe_static"] == jp["moe_static"]

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

        skip = {"cfg", "family", "layers", "cos", "sin", "moe_static"}
        same({k: v for k, v in jp.items() if k not in skip},
             {k: v for k, v in tp.items() if k not in skip}, "tree")
        for i, (a, b) in enumerate(zip(jp["layers"], tp["layers"])):
            same(a, b, f"layers.{i}")
        if quant:
            sfx = "_q4" if quant == "int4" else "_q"
            mo = tp["layers"][1]["moe"]
            assert mo["gate"].dtype == torch.float32       # router stays fp
            assert mo["wup_s"].shape == (4, 64)             # [E, N]
            assert mo["wup" + sfx].dim() == 3

    def test_capacity_model_warns(self, models):
        _, tm, _ = models["ernie45"]
        with pytest.warns(UserWarning, match="DROPLESS"):
            tgen.generate_cached(tm, PROMPTS[:1, :4], max_new_tokens=2,
                                 decode_strategy="greedy_search")


# --------------------------------------------------------------- engine
ENGINE_KW = dict(max_slots=2, page_size=4, prefill_chunk=36)
CHAINS = {"fused": {}, "split": dict(megafront=False, megadecode=False),
          "alternating": dict(ragged=False)}
#: (port path, layout) -> the JAX engine path it is held to: one JAX run
#: a layout (the JAX package's chains give one answer on this trace, as
#: the port's do; a JAX MoE engine compiles slowly)
RUNS = {(c, q): "alternating" for c in CHAINS
        for q in (None, "int8", "int4")}


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
    jm, tm, _ = models["qwen2_moe_dropless"]
    trace = _engine_trace(jm.config.vocab_size)
    jax_res = {}
    for chain, quant in set((v, k[1]) for k, v in RUNS.items()):
        jeng = jx.Engine(jm, enable_prefix_cache=False,
                         weight_only_quant=quant, **CHAINS[chain],
                         **ENGINE_KW)
        jax_res[(chain, quant)], _ = _drive(jeng, trace)
    out = {}
    for (chain, quant), jchain in RUNS.items():
        ops.reset_counts()
        teng = ServingEngine(tm, device="cpu", weight_only_quant=quant,
                             **CHAINS[chain], **ENGINE_KW)
        prefill = []
        if chain == "alternating":
            body = teng._prefill_body

            def counted(*args, body=body):
                prefill.append(1)
                return body(*args)
            teng._prefill_body = counted
        tres, _ = _drive(teng, trace)
        out[(chain, quant)] = dict(
            jres=jax_res[(jchain, quant)], tres=tres, teng=teng,
            counts=ops.launch_counts(), prefill=len(prefill), trace=trace)
    return out


class TestEngineAgainstJax:
    @pytest.mark.parametrize("run", list(RUNS))
    def test_greedy_tokens_identical(self, engine_runs, run):
        r = engine_runs[run]
        assert set(r["tres"]) == set(r["jres"]) == set(range(len(r["trace"])))
        for rid, ref in r["jres"].items():
            np.testing.assert_array_equal(r["tres"][rid], ref)

    @pytest.mark.parametrize("run", list(RUNS))
    def test_gmm_and_ffn_counts(self, engine_runs, run):
        chain, _ = run
        r = engine_runs[run]
        eng, n, c = r["teng"], r["teng"].launches, r["counts"]
        routed, dense = 1, 1
        if chain == "alternating":
            # the prefill chunk (36 rows) routes dropless, a decode
            # launch (2 rows) runs every expert on every token
            assert 0 < r["prefill"] < n
            assert c["gmm"]["plain_calls"] == 3 * routed * r["prefill"]
        else:
            assert eng.ragged and eng.prefill_chunk + eng.max_slots > 32
            assert c["gmm"]["plain_calls"] == 3 * routed * n
        assert c["gmm"]["launches"] == 0
        fused = chain == "fused"
        assert eng.megadecode == eng.megafront == fused
        # the fused chain: the o-proj + norm kernel on every layer, the
        # fused FFN on the dense one only
        assert c["fused_oproj_norm"]["plain_calls"] == \
            (routed + dense) * n * fused
        assert c["fused_ffn"]["plain_calls"] == dense * n * fused

    def test_intree_route_serves_through_gmm(self, models):
        from paddle_tpu_torch.serving import ServingEngine
        _, tm, _ = models["qwen2_moe_dropless"]
        with flags_guard(gmm_impl="intree"):
            eng = ServingEngine(tm, device="cpu", **ENGINE_KW)
            ops.reset_counts()
            eng.add_request(PROMPTS[0, :9], max_new_tokens=2, request_id=0)
            got = eng.run_to_completion()[0]
        assert ops.launch_counts()["gmm"]["plain_calls"] == 3 * eng.launches
        ref = tgen.generate_cached(tm, PROMPTS[:1, :9], max_new_tokens=2,
                                   decode_strategy="greedy_search")[0]
        np.testing.assert_array_equal(got, ref[0].numpy())

    def test_the_mla_family_still_names_its_item(self):
        # the MLA family is served on the unified step; its alternating
        # path is A5c's rest, and a backbone of no ported family is refused
        from paddle_tpu_torch.models import (DeepSeekV2ForCausalLM,
                                             deepseek_v2_tiny_config,
                                             llama_tiny_config)
        from paddle_tpu_torch.serving import ServingEngine
        mla = DeepSeekV2ForCausalLM(deepseek_v2_tiny_config(
            num_hidden_layers=1), device="cpu")
        with pytest.raises(NotImplementedError,
                           match="queue A item 5c's rest"):
            ServingEngine(mla, device="cpu", ragged=False)
        other = types.SimpleNamespace(config=llama_tiny_config(),
                                      model=object(), lm_head=None)
        with pytest.raises(NotImplementedError, match="queue A item 5"):
            ServingEngine(other, device="cpu")


# ------------------------------------------------------------ on the card
def _router_sizes(M_tokens, E, k, seed, live=None):
    """Group sizes of M_tokens tokens routed top-k over E experts by a
    seeded router (the serving step's sort). With `live`, the tokens from
    `live` on share one gate row, as the unified step's padding rows do
    in a decode step (they all route to the same k experts)."""
    g = torch.Generator().manual_seed(seed)
    gates = torch.softmax(torch.randn(M_tokens, E, generator=g), -1)
    if live is not None:
        gates[live:] = gates[live]
    topi = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :k]
    return torch.bincount(topi.reshape(-1), minlength=E).to(torch.int32)


#: (K, N, group sizes) of the bf16 kernels' tile, map and schedule edges
#: (chip_smoke.gmm_tile_edges): K not a multiple of the 64-deep box, N not
#: a multiple of the 256-column tile, group boundaries inside a 64-row
#: wgmma slice, one group of 5000 rows over many blocks, 160 groups of
#: 0-8 rows (more than SMs), empty first and last groups, fewer than 64
#: rows with the 30 tail rows
TILE_EDGES = [(136, 256, [70, 0, 90, 33]), (128, 200, [100, 50, 0, 77]),
              (128, 256, [37, 90, 5, 131, 1]), (256, 512, [0, 5000, 3]),
              (128, 128, [(7 * i) % 9 for i in range(160)]),
              (128, 256, [0, 40, 0, 60, 0]), (64, 64, [5, 0, 20])]


@pytest.mark.cuda
class TestGmmOnCard:
    """The CUDA kernel against gmm_plain on the same inputs on the card:
    ERNIE-4.5-21B-A3B's serving step (132 tokens, top-6 of 64 experts: M
    792) for the gate/up and the down product, routed as a mixed step
    (every token live) and as a decode step (4 live tokens, 128 padding
    rows in the same 6 groups), its prefill (2048 tokens: M 12288), and
    the edge cases (held by the tensor error alone: a flipped rounding
    moves a row of 64-512 outputs by up to ~3e-3), TILE_EDGES among
    them."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernel is CUDA C++ with no "
                        "CPU mode")
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("K,N,sizes", [
        (2560, 1536, 132), (1536, 2560, 132), (2560, 1536, 2048),
        (2560, 1536, "decode"), (1536, 2560, "decode"),
        (128, 256, [100, 200, 150, 62]), (128, 128, [0, 120, 0, 150]),
        (128, 128, [0, 0, 300]), (64, 72, [5, 0, 17, 1]), *TILE_EDGES])
    def test_matches_plain(self, dtype, K, N, sizes):
        routed = not isinstance(sizes, list)    # tokens through the router
        if sizes == "decode":
            gs = _router_sizes(132, 64, 6, seed=0, live=4)
            assert int(gs.max()) >= 128
        elif routed:
            gs = _router_sizes(sizes, 64, 6, seed=0)
        else:
            gs = torch.tensor(sizes, dtype=torch.int32)
        M = int(gs.sum()) + (0 if routed else 30)
        g = torch.Generator(device="cuda").manual_seed(1)
        lhs = torch.randn(M, K, device="cuda", generator=g).to(dtype)
        rhs = (0.02 * torch.randn(gs.numel(), K, N, device="cuda",
                                  generator=g)).to(dtype)
        gs = gs.cuda()
        before = gmm.launches
        with torch.no_grad():
            got = gmm(lhs, rhs, gs)
        torch.cuda.synchronize()
        assert gmm.launches == before + 1
        want = gmm_plain(lhs, rhs, gs)
        tail = int(gs.sum())
        assert got[tail:].count_nonzero() == 0
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        else:
            tensor, row = rel_errors(got[:tail], want[:tail])
            if routed:
                assert tensor < BF16_TENSOR_LIMIT and row < BF16_ROW_LIMIT, \
                    (tensor, row)
            else:
                assert tensor < BF16_EDGE_TENSOR_LIMIT, tensor

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("K,N,sizes", [
        (2560, 1536, 4096), (1536, 2560, 4096), (2560, 1536, 132),
        (128, 256, [0, 100, 0, 200, 150, 0]), (128, 128, [0, 300, 0]),
        (64, 72, [5, 0, 17, 1]), (128, 64, [10, 0, 25, 5]), *TILE_EDGES])
    def test_backward_kernels_match_plain(self, dtype, K, N, sizes):
        """dlhs (gmm_dlhs) against gmm_plain on rhs transposed, drhs
        (tgmm) against tgmm_plain: ERNIE's expert shapes at the training
        routing (4096 tokens top-6: M 24576) and a serving step's, and the
        edge cases with empty first, middle and last groups, one group
        holding every row, rows past the last group and narrow N; dlhs's
        tail rows and the empty groups' slabs exactly zero (tgmm's output
        takes memory just filled with NaN)."""
        routed = not isinstance(sizes, list)
        gs = _router_sizes(sizes, 64, 6, seed=3) if routed else \
            torch.tensor(sizes, dtype=torch.int32)
        M = int(gs.sum()) + (0 if routed else 30)
        G = gs.numel()
        g = torch.Generator(device="cuda").manual_seed(2)
        lhs = torch.randn(M, K, device="cuda", generator=g).to(dtype)
        rhs = (K ** -0.5 * torch.randn(G, K, N, device="cuda",
                                       generator=g)).to(dtype)
        dout = (0.05 * torch.randn(M, N, device="cuda",
                                   generator=g)).to(dtype)
        gs = gs.cuda()
        before = (gmm_dlhs.launches, tgmm.launches)
        dl = gmm_dlhs(dout, rhs, gs)
        torch.full((G, K, N), float("nan"), dtype=dtype, device="cuda")
        dr = tgmm(lhs, dout, gs)
        torch.cuda.synchronize()
        assert (gmm_dlhs.launches, tgmm.launches) == (before[0] + 1,
                                                      before[1] + 1)
        want_l = gmm_plain(dout, rhs.transpose(1, 2), gs)
        want_r = tgmm_plain(lhs, dout, gs)
        tail = int(gs.sum())
        empty = gs == 0
        assert dl[tail:].count_nonzero() == 0
        assert dr[empty].count_nonzero() == 0
        assert bool(torch.isfinite(dr).all())
        if dtype == torch.float32:
            torch.testing.assert_close(dl, want_l, atol=2e-5, rtol=2e-5)
            torch.testing.assert_close(dr, want_r, atol=2e-5, rtol=2e-5)
            return
        for got, want in ((dl[:tail], want_l[:tail]),
                          (dr[~empty].reshape(-1, N),
                           want_r[~empty].reshape(-1, N))):
            tensor, row = rel_errors(got, want)
            if routed:
                assert tensor < BWD_BF16_TENSOR_LIMIT and \
                    row < BWD_BF16_ROW_LIMIT, (tensor, row)
            else:
                assert tensor < BWD_BF16_EDGE_TENSOR_LIMIT, tensor

    def test_refuses_what_it_cannot_take(self):
        x = torch.zeros(8, 12, device="cuda", dtype=torch.bfloat16)
        w = torch.zeros(2, 12, 16, device="cuda", dtype=torch.bfloat16)
        gs = torch.tensor([4, 4], device="cuda", dtype=torch.int32)
        with pytest.raises(ValueError, match="multiples of 8"):
            gmm(x, w, gs)
        with pytest.raises(ValueError, match="multiples of 8"):
            tgmm(x, torch.zeros(8, 16, device="cuda",
                                dtype=torch.bfloat16), gs)
        # a gradient through gmm on the card launches dlhs and tgmm and
        # reads nothing back to the host
        x = torch.randn(8, 16, device="cuda", requires_grad=True)
        w = torch.randn(2, 16, 16, device="cuda", requires_grad=True)
        before = [f.launches for f in (gmm, gmm_dlhs, tgmm)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gmm(x, w, gs).sum().backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert [f.launches for f in (gmm, gmm_dlhs, tgmm)] == \
            [n + 1 for n in before]
        torch.testing.assert_close(x.grad, gmm_dlhs(
            torch.ones(8, 16, device="cuda"), w.detach(), gs))

    def test_moe_layer_gradients_on_the_card(self):
        """MoELayer's dropless forward trains on the card: its loss and
        every gradient (the router's through the gates and l_aux, the
        expert stacks' through tgmm, the input's through dlhs) against the
        same layer on the CPU, f32; 3 launches of each gmm kernel,
        nothing read back to the host."""
        from paddle_tpu_torch.incubate.moe import MoELayer
        cpu = MoELayer(64, 32, 8, top_k=2, dropless=True,
                       shared_expert_hidden=32, z_loss_weight=1e-3,
                       device="cpu",
                       generator=torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu).cuda()
        x = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(1))
        r = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(2))
        grads = []
        for layer, dev in ((cpu, "cpu"), (card, "cuda")):
            xi, ri = x.detach().to(dev).requires_grad_(), r.to(dev)
            before = [f.launches for f in (gmm, gmm_dlhs, tgmm)]
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                loss = (layer(xi) * ri).sum() + layer.l_aux
                loss.backward()
            finally:
                if dev == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            if dev == "cuda":
                assert [f.launches for f in (gmm, gmm_dlhs, tgmm)] == \
                    [n + 3 for n in before]
            grads.append({"x": xi.grad.cpu(), "loss": loss.detach().cpu(),
                          **{k: p.grad.cpu()
                             for k, p in layer.named_parameters()}})
        for k, g in grads[0].items():
            torch.testing.assert_close(grads[1][k], g, rtol=1e-4,
                                       atol=1e-5, msg=k)
        assert float(grads[1]["gate_weight"].abs().sum()) > 0

    def test_serving_step_does_not_read_back(self):
        # the dropless FFN on the card: nothing synchronises on routing
        g = torch.Generator(device="cuda").manual_seed(2)
        xt = torch.randn(40, 64, device="cuda", generator=g)
        gates = torch.softmax(torch.randn(40, 8, device="cuda",
                                          generator=g), -1)
        ws = [0.1 * torch.randn(s, device="cuda", generator=g)
              for s in ((8, 64, 32), (8, 64, 32), (8, 32, 64))]
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _ = dropless_expert_ffn(xt, gates, *ws, top_k=2,
                                       renormalize=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        yd, _ = dense_expert_ffn(xt, gates, *ws, top_k=2, renormalize=True)
        torch.testing.assert_close(y, yd, atol=2e-5, rtol=2e-5)

