"""The port's Llama serving slice against the JAX package on the CPU.

A seeded JAX LlamaForCausalLM (tiny config) carries its weights into
paddle_tpu_torch's LlamaForCausalLM (extract_state -> numpy ->
load_reference_state); a JAX ServingEngine and the port's ServingEngine
then run the same seeded join/leave trace, on each of the two chains:

- the fused chain, both engines at their defaults (megafront and
  megadecode on; the JAX megakernels in interpret mode): route counts
  per step of layers + 1 rms_norm and layers each of qkv_rope_append,
  ragged attention, oproj_norm and ffn, no rope_append;
- the split chain (megafront=False, megadecode=False on both): 2 * layers
  + 1 rms_norm, one rope_append and one ragged attention per layer per
  step.

Every request's greedy tokens must be identical and every unified step's
logits equal within 1e-4 (f32; the two frameworks sum in different
orders).

The alternating path (ragged=False on both engines: a prefill-chunk
launch and a decode-step launch per step, paged decode attention) is
held the same way under the port's two paged impls, launch by launch,
and to the port's own solo generate_cached tokens per request.

Weight-only int8 and int4 serving (`TestQuantizedEngineAgainstJax`): the
port's quantized trees equal the JAX package's byte for byte (the engine's
concatenated qkv slabs and scales too); both engines run the serving
trace on the fused chain, the split chain and the alternating path with
identical greedy tokens and the route counts of each path (int4: the LM
head, and on the split chain and the alternating path every projection,
through weight_only_linear; int8 through h @ (q * s), no kernel)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import extract_state
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.serving import ServingEngine

ENGINE_KW = dict(max_slots=2, page_size=4, prefill_chunk=4)


def _trace(V, n, seed, smin=2, smax=11, mmin=2, mmax=7):
    """Seeded request trace: (prompt, max_new, submit_at_step)."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, rng.randint(smin, smax)).astype(np.int32),
             int(rng.randint(mmin, mmax)), int(rng.randint(0, 4)))
            for _ in range(n)]


def _serving_trace(V, seeded: int = 5):
    """Three requests sharing a prompt prefix, then a seeded join/leave
    trace of `seeded` requests. Request 1 joins while request 0 decodes
    and forks its prefilled pages (live-donor prefix sharing, with a
    partially shared page that both copy on their next write); request
    2 later forks request 1's."""
    rng = np.random.RandomState(7)
    a = rng.randint(0, V, 6).astype(np.int32)
    tail = rng.randint(0, V, 3).astype(np.int32)
    shared = [(a, 6, 0), (np.concatenate([a, tail]), 4, 2),
              (np.concatenate([a[:5], tail[:1]]), 3, 3)]
    return shared + [(p, m, at + 3)
                     for p, m, at in _trace(V, seeded, seed=1)]


def _drive(eng, trace):
    """Submit each request at its step; step until idle."""
    pending = list(enumerate(trace))
    results, step, reqs = {}, 0, {}
    while pending or eng.has_work():
        still = []
        for i, (prompt, max_new, at) in pending:
            if at <= step:
                reqs[i] = eng.add_request(prompt, max_new_tokens=max_new,
                                          request_id=i)
            else:
                still.append((i, (prompt, max_new, at)))
        pending = still
        eng.step()
        results.update(eng.collect())
        step += 1
    return results, reqs


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    cfg_j = jax_tiny_config(num_hidden_layers=2)
    jm = JaxLlama(cfg_j)
    jm.eval()
    state = {k: np.asarray(v) for k, v in extract_state(jm).items()}
    tm = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=2),
                          device="cpu")
    load_reference_state(tm, state)
    return jm, tm, state


def _run_both(models, **chain):
    """Both engines over one seeded trace, with every unified step's
    logits captured (the JAX engine's through its jitted program)."""
    jm, tm, _ = models
    trace = _serving_trace(jm.config.vocab_size)

    jeng = JaxEngine(jm, enable_prefix_cache=False, **chain, **ENGINE_KW)
    jax_logits = []
    program = jeng._jit_unified

    def capture(*args):
        out = program(*args)
        jax_logits.append(np.asarray(out[0]))
        return out

    jeng._jit_unified = capture
    jres, _ = _drive(jeng, trace)

    ops.reset_counts()
    teng = ServingEngine(tm, device="cpu", **chain, **ENGINE_KW)
    torch_logits = []
    body = teng._body

    def capture_t(*args):
        out = body(*args)
        torch_logits.append(out[0].numpy().copy())
        return out

    teng._body = capture_t
    tres, treqs = _drive(teng, trace)
    counts = ops.launch_counts()
    return dict(jres=jres, tres=tres, treqs=treqs, jax_logits=jax_logits,
                torch_logits=torch_logits, counts=counts, teng=teng,
                jeng=jeng, trace=trace)


@pytest.fixture(scope="module")
def runs(models):
    """The split chain, asked for on both engines."""
    return _run_both(models, megafront=False, megadecode=False)


@pytest.fixture(scope="module")
def fused_runs(models):
    """The fused chain: both engines at their defaults."""
    return _run_both(models)


class TestWeightCarryOver:
    def test_state_keys_and_rope_tables(self, models):
        jm, tm, state = models
        assert set(tm.state_dict()) == set(state)
        for k, v in tm.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), state[k])
        # rope tables are recomputed on both sides (non-persistable):
        # PyTorch's and XLA's f32 cos/sin agree to one f32 ulp at 1.0
        for name in ("rope_cos", "rope_sin"):
            ref = np.asarray(getattr(jm.llama, name)._data)
            got = getattr(tm.llama, name).numpy()
            assert got.dtype == np.float32 and got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 ** -23)

    def test_missing_key_raises(self, models):
        _, tm, state = models
        bad = dict(state)
        bad.pop("lm_head.weight")
        with pytest.raises(KeyError, match="missing"):
            load_reference_state(tm, bad)

    def test_extra_key_raises(self, models):
        _, tm, state = models
        bad = dict(state)
        bad["llama.rope_cos"] = np.zeros((1,), np.float32)
        with pytest.raises(KeyError, match="extra"):
            load_reference_state(tm, bad)

    def test_shape_mismatch_raises_before_writing(self, models):
        _, tm, state = models
        bad = dict(state)
        bad["llama.norm.weight"] = np.zeros((7,), np.float32)
        before = tm.llama.embed_tokens.weight.detach().clone()
        bad["llama.embed_tokens.weight"] = np.zeros_like(
            state["llama.embed_tokens.weight"])
        with pytest.raises(ValueError, match="llama.norm.weight"):
            load_reference_state(tm, bad)
        torch.testing.assert_close(tm.llama.embed_tokens.weight.detach(),
                                   before)

    def test_forward_names_its_roadmap_item(self, models):
        # its roadmap item (queue A item 2, the training forward) is done:
        # the carried-over model's forward gives the JAX model's logits
        jm, tm, _ = models
        ids = np.arange(8, dtype=np.int32)[None] * 7
        got = tm(torch.from_numpy(ids).long()).detach().numpy()
        want = np.asarray(jm(paddle.to_tensor(ids))._data)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


class TestEngineAgainstJax:
    def test_greedy_tokens_identical(self, runs):
        assert set(runs["tres"]) == set(runs["jres"]) == \
            set(range(len(runs["trace"])))
        for rid, ref in runs["jres"].items():
            np.testing.assert_array_equal(runs["tres"][rid], ref)

    def test_every_step_logits_within_1e4(self, runs):
        jl, tl = runs["jax_logits"], runs["torch_logits"]
        assert len(jl) == len(tl) > 0
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)

    def test_prefix_sharing_forked_and_copied(self, runs):
        # requests 1 and 2 rode a live donor's pages, and the partially
        # shared page was copied on first write
        assert runs["treqs"][1].shared_tokens == 6
        assert runs["treqs"][2].shared_tokens == 5
        assert runs["teng"].allocator.cow_copies > 0

    def test_route_counts_per_layer(self, runs):
        steps = runs["teng"].launches
        layers = 2
        assert steps == len(runs["torch_logits"])
        c = runs["counts"]
        assert c["fused_rms_norm"] == {"launches": 0,
                                       "plain_calls": (2 * layers + 1)
                                       * steps}
        assert c["fused_rope_append"] == {"launches": 0,
                                          "plain_calls": layers * steps}
        assert c["ragged_paged_attention"] == {"launches": 0,
                                               "plain_calls": layers * steps}

    def test_pool_returned_to_allocator(self, runs):
        st = runs["teng"].allocator.stats()
        assert st["sequences"] == 0 and st["pages_used"] == 0


class TestFusedEngineAgainstJax:
    """The default engines: fused_rms_norm -> fused_qkv_rope_append ->
    ragged_paged_attention -> fused_oproj_norm -> fused_ffn per layer."""

    def test_both_default_to_the_fused_chain(self, models, fused_runs):
        for eng in (fused_runs["jeng"], fused_runs["teng"]):
            assert eng.megafront and eng.megadecode
            assert eng.front_half_launches == 2
            assert eng.back_half_launches == 2
        split = ServingEngine(models[1], device="cpu", megafront=False,
                              megadecode=False, **ENGINE_KW)
        assert split.front_half_launches == 5
        assert split.back_half_launches == 6

    def test_greedy_tokens_identical(self, fused_runs):
        assert set(fused_runs["tres"]) == set(fused_runs["jres"]) == \
            set(range(len(fused_runs["trace"])))
        for rid, ref in fused_runs["jres"].items():
            np.testing.assert_array_equal(fused_runs["tres"][rid], ref)

    def test_every_step_logits_within_1e4(self, fused_runs):
        jl, tl = fused_runs["jax_logits"], fused_runs["torch_logits"]
        assert len(jl) == len(tl) > 0
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)

    def test_route_counts_per_layer(self, fused_runs):
        steps = fused_runs["teng"].launches
        layers = 2
        assert steps == len(fused_runs["torch_logits"])
        c = fused_runs["counts"]
        want = {"fused_rms_norm": layers + 1, "fused_qkv_rope_append": layers,
                "ragged_paged_attention": layers,
                "fused_oproj_norm": layers, "fused_ffn": layers,
                "fused_rope_append": 0}
        for name, per_step in want.items():
            assert c[name] == {"launches": 0,
                               "plain_calls": per_step * steps}, name

    def test_qkv_slab_is_the_three_projections(self, models, fused_runs):
        _, tm, _ = models
        L = fused_runs["teng"]._p["layers"][0]
        a = tm.llama.layers[0].self_attn
        assert "wq" not in L and "wk" not in L and "wv" not in L
        torch.testing.assert_close(
            L["wqkv"], torch.cat([a.q_proj.weight, a.k_proj.weight,
                                  a.v_proj.weight], dim=-1),
            rtol=0, atol=0)


def _jax_alternating(models):
    """The JAX alternating engine (ragged=False, its default
    FLAGS_paged_impl "intree": the v2 Pallas kernel in interpret mode)
    over the seeded serving trace, every launch's logits captured:
    (results, logits, trace)."""
    jm, _, _ = models
    trace = _serving_trace(jm.config.vocab_size)
    jeng = JaxEngine(jm, enable_prefix_cache=False, ragged=False,
                     **ENGINE_KW)
    jax_logits = []

    def capture(program):
        def run(*args):
            out = program(*args)
            jax_logits.append(np.asarray(out[0]))
            return out
        return run

    jeng._jit_prefill = capture(jeng._jit_prefill)
    jeng._jit_decode = capture(jeng._jit_decode)
    jres, _ = _drive(jeng, trace)
    return jres, jax_logits, trace


def _run_alternating(models, impl, jax_side):
    """The port's alternating engine under `impl` over the trace of the
    JAX run `jax_side` (`_jax_alternating`, shared by both impls: the
    JAX engine is the same for either), every launch's logits
    captured."""
    from paddle_tpu_torch.flags import flags_guard
    from paddle_tpu_torch.ops import paged_attention as routes
    _, tm, _ = models
    jres, jax_logits, trace = jax_side

    ops.reset_counts()
    routes.reset_route_counts()
    with flags_guard(paged_impl=impl):
        teng = ServingEngine(tm, device="cpu", ragged=False, **ENGINE_KW)
    torch_logits, decode_steps = [], []

    def capture_t(body, decode):
        def run(*args):
            out = body(*args)
            torch_logits.append(out[0].numpy().copy())
            decode_steps.append(decode)
            return out
        return run

    teng._prefill_body = capture_t(teng._prefill_body, False)
    teng._decode_body = capture_t(teng._decode_body, True)
    tres, treqs = _drive(teng, trace)
    return dict(jres=jres, tres=tres, treqs=treqs, jax_logits=jax_logits,
                torch_logits=torch_logits, decode_steps=sum(decode_steps),
                counts=ops.launch_counts(), routes=dict(routes.route_counts),
                teng=teng, trace=trace)


@pytest.fixture(scope="module")
def alt_runs(models):
    """The alternating path on both impls of the port."""
    jax_side = _jax_alternating(models)
    return {impl: _run_alternating(models, impl, jax_side)
            for impl in ("intree", "intree_v1")}


class TestAlternatingEngineAgainstJax:
    """ServingEngine(ragged=False): a prefill-chunk launch then a
    decode-step launch per engine step; the decode step's attention
    through paged_attention (v2 under "intree", v1 under "intree_v1")."""

    IMPLS = ("intree", "intree_v1")

    @pytest.mark.parametrize("impl", IMPLS)
    def test_greedy_tokens_identical(self, alt_runs, impl):
        run = alt_runs[impl]
        assert set(run["tres"]) == set(run["jres"]) == \
            set(range(len(run["trace"])))
        for rid, ref in run["jres"].items():
            np.testing.assert_array_equal(run["tres"][rid], ref)

    @pytest.mark.parametrize("impl", IMPLS)
    def test_every_launch_logits_within_1e4(self, alt_runs, impl):
        jl, tl = alt_runs[impl]["jax_logits"], alt_runs[impl]["torch_logits"]
        assert len(jl) == len(tl) == alt_runs[impl]["teng"].launches > 0
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("impl,route,kernel,other", [
        ("intree", "paged_intree", "paged_decode_attention_v2",
         "paged_decode_attention"),
        ("intree_v1", "paged_intree_v1", "paged_decode_attention",
         "paged_decode_attention_v2")])
    def test_route_counts_per_layer(self, alt_runs, impl, route, kernel,
                                    other):
        run = alt_runs[impl]
        layers, eng = 2, run["teng"]
        dec, launches = run["decode_steps"], eng.launches
        assert eng.paged_impl == impl and 0 < dec < launches
        assert not (eng.ragged or eng.megafront or eng.megadecode)
        c = run["counts"]
        assert c["fused_rms_norm"] == {
            "launches": 0, "plain_calls": (2 * layers + 1) * launches}
        assert c[kernel] == {"launches": 0, "plain_calls": layers * dec}
        assert c[other] == {"launches": 0, "plain_calls": 0}
        assert run["routes"] == dict(
            {k: 0 for k in run["routes"]}, **{route: layers * dec})
        for name in ("ragged_paged_attention", "fused_rope_append",
                     "fused_qkv_rope_append", "fused_oproj_norm",
                     "fused_ffn"):
            assert c[name] == {"launches": 0, "plain_calls": 0}, name

    def test_prefix_sharing_forked(self, alt_runs):
        treqs = alt_runs["intree"]["treqs"]
        assert treqs[1].shared_tokens == 6 and treqs[2].shared_tokens == 5
        st = alt_runs["intree"]["teng"].allocator.stats()
        assert st["sequences"] == 0 and st["pages_used"] == 0

    def test_tokens_equal_solo_generate_cached(self, models, alt_runs):
        from paddle_tpu_torch.generation import generate_cached
        _, tm, _ = models
        run = alt_runs["intree"]
        for rid, (prompt, max_new, _) in enumerate(run["trace"]):
            gen, _ = generate_cached(tm, prompt[None], max_new_tokens=max_new,
                                     decode_strategy="greedy_search")
            np.testing.assert_array_equal(gen[0].numpy(), run["tres"][rid])

    def test_unified_and_alternating_identical(self, runs, fused_runs,
                                               alt_runs):
        # on the CPU both dispatch paths and both chains give one answer,
        # and the unified step needs strictly fewer launches (a step with
        # prefill and decode work is two launches on the alternating path)
        alt = alt_runs["intree"]
        for rid, toks in alt["tres"].items():
            np.testing.assert_array_equal(toks, runs["tres"][rid])
            np.testing.assert_array_equal(toks, fused_runs["tres"][rid])
        assert runs["teng"].launches < alt["teng"].launches
        assert fused_runs["teng"].launches < alt["teng"].launches


QUANT = ("int8", "int4")
CHAINS = {"fused": {}, "split": dict(megafront=False, megadecode=False),
          "alternating": dict(ragged=False)}


def _run_quant(models, quant, chain):
    """Both engines over the seeded serving trace with weight_only_quant
    `quant` on `chain`; the port's counts, launches and decode launches."""
    jm, tm, _ = models
    trace = _serving_trace(jm.config.vocab_size)
    kw = dict(CHAINS[chain], weight_only_quant=quant, **ENGINE_KW)
    jeng = JaxEngine(jm, enable_prefix_cache=False, **kw)
    jres, _ = _drive(jeng, trace)
    ops.reset_counts()
    teng = ServingEngine(tm, device="cpu", **kw)
    decode = []
    if chain == "alternating":
        body = teng._decode_body

        def counted(*args):
            decode.append(1)
            return body(*args)
        teng._decode_body = counted
    tres, _ = _drive(teng, trace)
    return dict(jres=jres, tres=tres, jeng=jeng, teng=teng, trace=trace,
                counts=ops.launch_counts(), decode=len(decode))


@pytest.fixture(scope="module")
def quant_runs(models):
    return {(q, c): _run_quant(models, q, c) for q in QUANT for c in CHAINS}


class TestQuantizedEngineAgainstJax:
    """ServingEngine(weight_only_int8=True / weight_only_quant=...) on
    every path, against the JAX engine with the same knobs."""

    @pytest.mark.parametrize("quant", QUANT)
    def test_decode_tree_byte_identical(self, models, quant):
        from paddle_tpu import generation as jgen
        from paddle_tpu_torch import generation as tgen
        jm, tm, _ = models
        jp = jgen._decode_params(jm, weight_only_quant=quant)
        tp = tgen._llama_decode_params(tm, weight_only_quant=quant)
        assert tp["head"] is None and jp["head"] is None
        tops = {k for k in tp if k.startswith("head_")}
        assert tops == {k for k in jp if k.startswith("head_")} == {
            "head_q4" if quant == "int4" else "head_q", "head_s"}
        for a, b in [(jp, tp)] + list(zip(jp["layers"], tp["layers"])):
            keys = set(b) - {"cfg", "family", "embed", "norm", "cos", "sin",
                             "layers", "head"}
            assert keys == set(a) - {"cfg", "family", "embed", "norm",
                                     "cos", "sin", "layers", "head"}
            for k in keys:
                want = np.asarray(a[k])
                got = b[k].numpy()
                assert got.dtype == want.dtype, k
                np.testing.assert_array_equal(got, want, err_msg=k)

    @pytest.mark.parametrize("quant", QUANT)
    def test_engine_slab_byte_identical(self, quant_runs, quant):
        run = quant_runs[(quant, "fused")]
        sfx = "_q4" if quant == "int4" else "_q"
        for jl, tl in zip(run["jeng"]._p["layers"], run["teng"]._p["layers"]):
            for k in ("wqkv" + sfx, "wqkv_s"):
                want = np.asarray(jl[k])
                assert tl[k].numpy().dtype == want.dtype
                np.testing.assert_array_equal(tl[k].numpy(), want)
            for k in ("wq", "wk", "wv"):
                assert k + sfx not in tl and k + "_s" not in tl

    @pytest.mark.parametrize("quant", QUANT)
    @pytest.mark.parametrize("chain", list(CHAINS))
    def test_greedy_tokens_identical(self, quant_runs, quant, chain):
        run = quant_runs[(quant, chain)]
        assert set(run["tres"]) == set(run["jres"]) == \
            set(range(len(run["trace"])))
        for rid, ref in run["jres"].items():
            np.testing.assert_array_equal(run["tres"][rid], ref)

    @pytest.mark.parametrize("quant", QUANT)
    @pytest.mark.parametrize("chain", list(CHAINS))
    def test_route_counts(self, quant_runs, quant, chain):
        run = quant_runs[(quant, chain)]
        eng, L = run["teng"], 2
        n, dec = eng.launches, run["decode"]
        assert eng.megafront == eng.megadecode == (chain == "fused")
        int4 = quant == "int4"
        per = {"fused": {"fused_rms_norm": L + 1,
                         "fused_qkv_rope_append": L,
                         "ragged_paged_attention": L,
                         "fused_oproj_norm": L, "fused_ffn": L,
                         "weight_only_linear": int(int4)},
               "split": {"fused_rms_norm": 2 * L + 1,
                         "fused_rope_append": L,
                         "ragged_paged_attention": L,
                         "weight_only_linear": (7 * L + 1) * int4},
               "alternating": {"fused_rms_norm": 2 * L + 1,
                               "weight_only_linear": (7 * L + 1) * int4}}
        want = {k: v * n for k, v in per[chain].items()}
        if chain == "alternating":
            assert 0 < dec < n
            want["paged_decode_attention_v2"] = L * dec
        for name, c in run["counts"].items():
            assert c == {"launches": 0,
                         "plain_calls": want.get(name, 0)}, name

    def test_int4_engine_equals_solo_generate_cached(self, models,
                                                     quant_runs):
        from paddle_tpu_torch.generation import generate_cached
        _, tm, _ = models
        run = quant_runs[("int4", "fused")]
        for rid, (prompt, max_new, _) in enumerate(run["trace"]):
            gen, _ = generate_cached(tm, prompt[None], max_new_tokens=max_new,
                                     decode_strategy="greedy_search",
                                     weight_only_quant="int4")
            np.testing.assert_array_equal(gen[0].numpy(), run["tres"][rid])

    def test_int8_bool_knob_is_the_int8_layout(self, models, quant_runs):
        _, tm, _ = models
        eng = ServingEngine(tm, device="cpu", weight_only_int8=True,
                            **ENGINE_KW)
        for rid, (prompt, max_new, _) in enumerate(
                quant_runs[("int8", "fused")]["trace"][:3]):
            eng.add_request(prompt, max_new_tokens=max_new, request_id=rid)
        out = eng.run_to_completion()
        for rid in out:
            np.testing.assert_array_equal(
                out[rid], quant_runs[("int8", "fused")]["tres"][rid])


class TestLayersAgainstJax:
    """Linear, Embedding and RMSNorm: same weights (carried by name),
    same outputs as the JAX package's layers, f32 at 2e-5."""

    def test_forward(self):
        from paddle_tpu import nn as jnn
        from paddle_tpu_torch import nn as tnn
        paddle.seed(1)
        x = np.random.RandomState(0).randn(3, 5, 16).astype(np.float32)
        ids = np.asarray([[1, 7, 3]], np.int64)
        pairs = [(jnn.Linear(16, 8), tnn.Linear(16, 8, device="cpu"), x),
                 (jnn.Linear(16, 8, bias_attr=False),
                  tnn.Linear(16, 8, bias_attr=False, device="cpu"), x),
                 (jnn.RMSNorm(16, 1e-5), tnn.RMSNorm(16, 1e-5, device="cpu"),
                  x),
                 (jnn.Embedding(10, 4), tnn.Embedding(10, 4, device="cpu"),
                  ids)]
        for jl, tl, inp in pairs:
            state = {k: np.asarray(v) for k, v in extract_state(jl).items()}
            if isinstance(tl, tnn.RMSNorm):   # ones on both sides: vary it
                state["weight"] = state["weight"] * np.linspace(
                    0.5, 2, 16, dtype=np.float32)
                jl.weight._data = jl.weight._data * np.linspace(
                    0.5, 2, 16, dtype=np.float32)
            load_reference_state(tl, state)
            want = np.asarray(jl(paddle.to_tensor(inp))._data)
            got = tl(torch.from_numpy(inp)).detach().numpy()
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


class TestEngineOptions:
    def test_bf16_engine_on_cpu(self, models):
        # the model dtype reaches the pools, the kernels' plain versions
        # and the argmax; every request completes
        _, tm, state = models
        m16 = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=2),
                               device="cpu", dtype=torch.bfloat16)
        load_reference_state(m16, state)
        eng = ServingEngine(m16, device="cpu", **ENGINE_KW)
        assert eng._pools[0][0].dtype == torch.bfloat16
        for i in range(3):
            eng.add_request(np.arange(3 + i) + 5 * i, max_new_tokens=4,
                            request_id=i)
        out = eng.run_to_completion()
        assert sorted(out) == [0, 1, 2]
        assert all(v.shape == (4,) for v in out.values())
        assert eng.last_logits.dtype == torch.bfloat16

    def test_run_to_completion_matches_stepping(self, models, runs):
        _, tm, _ = models
        eng = ServingEngine(tm, device="cpu", **ENGINE_KW)
        for i, (prompt, max_new, _) in enumerate(runs["trace"][:3]):
            eng.add_request(prompt, max_new_tokens=max_new, request_id=i)
        out = eng.run_to_completion()
        for i in range(3):
            np.testing.assert_array_equal(out[i], runs["jres"][i])

    @pytest.mark.parametrize("kw,item", [
        (dict(enable_prefix_cache=True), 6), (dict(spec_decode=2), 6),
        (dict(preemption=True), 6), (dict(role="prefill"), 6),
        (dict(slo_targets={"ttft_p90": 1.0}), 6),
    ])
    def test_unported_features_name_their_item(self, models, kw, item):
        _, tm, _ = models
        with pytest.raises(NotImplementedError,
                           match=f"queue A item {item}"):
            ServingEngine(tm, device="cpu", **kw)

    def test_other_families_name_their_item(self):
        # a MoE / MLA model (its backbone is `model`, as in the JAX
        # package): refused, not served (gpt and qwen2 are served:
        # test_torch_gpt.py, test_torch_qwen2.py)
        other = SimpleNamespace(config=llama_tiny_config(), model=object(),
                                lm_head=None)
        with pytest.raises(NotImplementedError, match="queue A item 5"):
            ServingEngine(other, device="cpu")

    def test_eos_and_max_context(self, models):
        _, tm, _ = models
        eng = ServingEngine(tm, device="cpu", max_context=32, **ENGINE_KW)
        with pytest.raises(ValueError, match="max_context"):
            eng.add_request(np.arange(30), max_new_tokens=5)
        probe = ServingEngine(tm, device="cpu", **ENGINE_KW)
        probe.add_request(np.arange(5), max_new_tokens=3, request_id=0)
        first = int(probe.run_to_completion()[0][0])
        eng.add_request(np.arange(5), max_new_tokens=6, eos_token_id=first,
                        pad_token_id=-1, request_id=1)
        out = eng.run_to_completion()[1]
        assert out[0] == first and (out[1:] == -1).all()


class TestHostLogicAgainstJax:
    """The port's allocator and scheduler against the JAX package's on
    the same seeded operation sequences: same outcomes, page tables,
    copy-on-write copies, slots and queues after every operation."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_allocator(self, seed):
        from paddle_tpu.serving.block_allocator import \
            PageBlockAllocator as JaxAllocator
        from paddle_tpu_torch.serving import PageBlockAllocator
        rng = np.random.RandomState(seed)
        pair = (JaxAllocator(24, 4, 6), PageBlockAllocator(24, 4, 6))
        live = []

        def both(name, *args):
            outs = []
            for alloc in pair:
                try:
                    outs.append(("ok", getattr(alloc, name)(*args)))
                except (ValueError, RuntimeError) as e:  # Overloaded too
                    outs.append((type(e).__name__, None))
            assert outs[0] == outs[1], (name, args)
            return outs[0][0] == "ok"

        for step in range(150):
            op = rng.randint(4)
            if op == 0 or not live:
                total = int(rng.randint(1, 25))
                if live and rng.rand() < 0.5:
                    parent = live[rng.randint(len(live))]
                    share = int(rng.randint(0, pair[1].seq_length(parent)
                                            + 1))
                    ok = both("fork", parent, step, share, max(total, share))
                else:
                    ok = both("allocate", step, total)
                if ok:
                    live.append(step)
            elif op == 1:
                both("extend", live[rng.randint(len(live))],
                     int(rng.randint(1, 5)))
            elif op == 2:
                sid = live[rng.randint(len(live))]
                both("shrink", sid,
                     int(rng.randint(0, pair[1].seq_length(sid) + 1)))
            else:
                both("free", live.pop(rng.randint(len(live))))
            assert pair[0].available_pages == pair[1].available_pages
            assert pair[0].free_pages == pair[1].free_pages
            for sid in live:
                np.testing.assert_array_equal(pair[0].table(sid),
                                              pair[1].table(sid))
                assert pair[0].seq_length(sid) == pair[1].seq_length(sid)

    def test_scheduler(self):
        from paddle_tpu.serving.scheduler import Request as JaxRequest
        from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
        from paddle_tpu_torch.serving import Request, Scheduler
        rng = np.random.RandomState(3)
        budgets = {"a": 40}
        pair = (JaxScheduler(3, tenant_budgets=budgets),
                Scheduler(3, tenant_budgets=budgets))
        kinds = (JaxRequest, Request)
        reqs = ({}, {})
        for step in range(150):
            op = rng.randint(3)
            if op == 0:
                prompt = rng.randint(0, 50, rng.randint(1, 20))
                kw = dict(max_new_tokens=int(rng.randint(1, 20)),
                          request_id=step, priority=int(rng.randint(3)),
                          tenant=(None, "a", "b")[rng.randint(3)])
                for s, kind, rs in zip(pair, kinds, reqs):
                    rs[step] = s.submit(kind(prompt, **kw))
            elif op == 1:
                picks = [s.next_admittable() for s in pair]
                assert [getattr(r, "request_id", None) for r in picks] == \
                    [getattr(picks[0], "request_id", None)] * 2
                if picks[0] is not None:
                    slots = [s.admit(r) for s, r in zip(pair, picks)]
                    assert slots[0] == slots[1]
            else:
                active = pair[1].active()
                if active:
                    rid = active[rng.randint(len(active))][1].request_id
                    for s, rs in zip(pair, reqs):
                        s.release(rs[rid])
            for attr in ("slots", "waiting"):
                ids = [[getattr(r, "request_id", None)
                        for r in getattr(s, attr)] for s in pair]
                assert ids[0] == ids[1]
            assert pair[0]._tenant_tokens == pair[1]._tenant_tokens

    def test_admission_and_deadline_policy(self, models):
        from paddle_tpu_torch import resilience
        _, tm, _ = models
        gate = SimpleNamespace(_admission=(1, 0.0))
        eng = ServingEngine(tm, device="cpu", config=gate, **ENGINE_KW)
        eng.add_request(np.arange(5), max_new_tokens=2)
        with pytest.raises(resilience.Overloaded):
            eng.add_request(np.arange(5), max_new_tokens=2)
        late = SimpleNamespace(_deadline_s=1e-9)
        eng = ServingEngine(tm, device="cpu", config=late, **ENGINE_KW)
        misses = resilience.deadline_misses()
        eng.add_request(np.arange(5), max_new_tokens=2, request_id=7)
        res = eng.run_to_completion()[7]
        assert isinstance(res, resilience.TimeoutResult) and not res
        assert resilience.deadline_misses() == misses + 1
        assert eng.allocator.stats()["sequences"] == 0
