"""The port's Qwen2 slice against the JAX package on the CPU.

A seeded JAX Qwen2ForCausalLM (qwen2_tiny_config: 2 layers, 4 query heads
on 2 KV heads, rope theta 1e6, tied head; random q/k/v biases, which its
initializer leaves at 0) carries its weights into the port's model
(extract_state -> numpy -> load_reference_state, key for key). Then:

- forward logits within 2e-5 (f32), `generate` and `generate_cached`
  greedy tokens identical, scores within 1e-5 (JAX at "highest" matmul
  precision);
- the decode tree equals JAX's `_decode_params` byte for byte, the
  biases included, in the fp, int8 and int4 layouts, and so does the
  engine's concatenated qkv slab with its bias (`bqkv`);
- `ServingEngine` greedy tokens identical to the JAX engine's over the
  seeded join/leave trace of test_torch_llama_serving.py (its three
  requests that share a prefix and two seeded ones) on the fused
  chain, the split chain and the alternating path under both paged
  impls, with every kernel wrapper's calls per step; with
  weight_only_quant "int8" and "int4" on the fused and the split chain;
  `generate_cached` with both layouts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu.jit import extract_state
from paddle_tpu.models.qwen2 import Qwen2ForCausalLM as JaxQwen2
from paddle_tpu.models.qwen2 import qwen2_tiny_config as jax_tiny_config
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.flags import flags_guard
from paddle_tpu_torch.models import Qwen2ForCausalLM, qwen2_tiny_config
from paddle_tpu_torch.ops import paged_attention as routes
from paddle_tpu_torch.serving import ServingEngine

from test_torch_llama_serving import ENGINE_KW, _drive, _serving_trace

LAYERS = 2
NEW = 6
QUANT = ("int8", "int4")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxQwen2(jax_tiny_config())
    jm.eval()
    rng = np.random.RandomState(6)
    for name, p in jm.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.5 * rng.randn(*p._data.shape),
                                  jnp.float32)
    state = {k: np.asarray(v) for k, v in extract_state(jm).items()}
    tm = Qwen2ForCausalLM(qwen2_tiny_config(), device="cpu")
    load_reference_state(tm, state)
    return jm, tm, state


@pytest.fixture(scope="module")
def prompts():
    return np.random.RandomState(3).randint(0, 512, (2, 7)).astype(np.int32)


def _jax_run(fn, jm, ids, **kw):
    with jax.default_matmul_precision("highest"):
        gen, sc = fn(jm, paddle.to_tensor(ids), **kw)
    return np.asarray(gen._data), np.asarray(sc._data)


class TestModelAgainstJax:
    def test_state_keys_and_biases(self, models):
        jm, tm, state = models
        assert set(tm.state_dict()) == set(state)
        assert tm.lm_head is None and jm.lm_head is None     # tied head
        assert tm.config.rope_theta == 1e6 and tm.config.qkv_bias
        a = tm.qwen2.layers[0].self_attn
        assert a.q_proj.bias is not None and a.o_proj.bias is None
        np.testing.assert_array_equal(
            a.k_proj.bias.detach().numpy(),
            state["qwen2.layers.0.self_attn.k_proj.bias"])
        assert float(a.k_proj.bias.detach().abs().max()) > 0

    def test_forward_logits_within_2e5(self, models):
        jm, tm, _ = models
        ids = (np.arange(9, dtype=np.int32)[None] * 37) % 512
        got = tm(torch.from_numpy(ids).long()).detach().numpy()
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jm(paddle.to_tensor(ids))._data)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("name", ["generate", "generate_cached"])
    def test_greedy_tokens_identical(self, models, prompts, name):
        jm, tm, _ = models
        kw = dict(max_new_tokens=NEW, decode_strategy="greedy_search")
        want_gen, want_sc = _jax_run(getattr(jgen, name), jm, prompts, **kw)
        gen, sc = getattr(tgen, name)(tm, prompts, **kw)
        np.testing.assert_array_equal(gen.numpy(), want_gen)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-5)

    @pytest.mark.parametrize("quant", QUANT)
    def test_generate_cached_quantized(self, models, prompts, quant):
        jm, tm, _ = models
        kw = dict(max_new_tokens=NEW, decode_strategy="greedy_search",
                  weight_only_quant=quant)
        want_gen, want_sc = _jax_run(jgen.generate_cached, jm, prompts, **kw)
        ops.reset_counts()
        gen, sc = tgen.generate_cached(tm, prompts, **kw)
        np.testing.assert_array_equal(gen.numpy(), want_gen)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-5)
        # seven projections a layer; the tied head stays the fp embedding
        wol = 7 * LAYERS * NEW if quant == "int4" else 0
        assert ops.launch_counts()["weight_only_linear"] == {
            "launches": 0, "plain_calls": wol}

    @pytest.mark.parametrize("quant", (None,) + QUANT)
    def test_decode_tree_byte_identical(self, models, quant):
        jm, tm, _ = models
        jp = jgen._decode_params(jm, weight_only_quant=quant)
        tp = tgen._decode_params(tm, weight_only_quant=quant)
        assert tp["family"] == jp["family"] == "llama"
        skip = {"cfg", "family", "layers", "cos", "sin"}
        for a, b in [(jp, tp)] + list(zip(jp["layers"], tp["layers"])):
            assert set(b) - skip == set(a) - skip
            for k in set(b) - skip:
                if b[k] is None:
                    assert a[k] is None, k
                    continue
                want = np.asarray(a[k])
                assert b[k].numpy().dtype == want.dtype, k
                np.testing.assert_array_equal(b[k].numpy(), want, err_msg=k)
        assert {"bq", "bk", "bv"} <= set(tp["layers"][0])


CHAINS = {"fused": {}, "split": dict(megafront=False, megadecode=False),
          "alternating": dict(ragged=False)}
PER_STEP = {
    "fused": {"fused_rms_norm": (1, 1), "fused_qkv_rope_append": (1, 0),
              "ragged_paged_attention": (1, 0), "fused_oproj_norm": (1, 0),
              "fused_ffn": (1, 0)},
    "split": {"fused_rms_norm": (2, 1), "fused_rope_append": (1, 0),
              "ragged_paged_attention": (1, 0)}}
ALT = {"intree": "paged_decode_attention_v2",
       "intree_v1": "paged_decode_attention"}
RUNS = [("fused", "intree", None), ("split", "intree", None),
        ("alternating", "intree", None), ("alternating", "intree_v1", None),
        ("fused", "intree", "int8"), ("split", "intree", "int8"),
        ("fused", "intree", "int4"), ("split", "intree", "int4")]


def _run(models, chain, impl, quant, jax_runs):
    """Both engines over the serving trace; the JAX engine's run is
    shared by the runs that differ only on the port's side (its
    FLAGS_paged_impl, which the JAX engine does not read here)."""
    jm, tm, _ = models
    trace = _serving_trace(jm.config.vocab_size, seeded=2)
    kw = dict(CHAINS[chain], weight_only_quant=quant, **ENGINE_KW)
    if (chain, quant) not in jax_runs:
        jeng = JaxEngine(jm, enable_prefix_cache=False, **kw)
        jax_runs[(chain, quant)] = jeng, _drive(jeng, trace)[0]
    jeng, jres = jax_runs[(chain, quant)]
    ops.reset_counts()
    routes.reset_route_counts()
    with flags_guard(paged_impl=impl):
        teng = ServingEngine(tm, device="cpu", **kw)
    decode = []
    if chain == "alternating":
        body = teng._decode_body

        def counted(*args):
            decode.append(1)
            return body(*args)
        teng._decode_body = counted
    tres, _ = _drive(teng, trace)
    return dict(jres=jres, tres=tres, teng=teng, jeng=jeng, trace=trace,
                counts=ops.launch_counts(), routes=dict(routes.route_counts),
                decode=len(decode))


@pytest.fixture(scope="module")
def runs(models):
    jax_runs = {}
    return {run: _run(models, *run, jax_runs) for run in RUNS}


class TestEngineAgainstJax:
    @pytest.mark.parametrize("run", RUNS)
    def test_greedy_tokens_identical(self, runs, run):
        r = runs[run]
        assert set(r["tres"]) == set(r["jres"]) == set(range(len(r["trace"])))
        for rid, ref in r["jres"].items():
            np.testing.assert_array_equal(r["tres"][rid], ref)

    @pytest.mark.parametrize("run", RUNS)
    def test_route_counts(self, runs, run):
        chain, impl, quant = run
        r = runs[run]
        eng, n = r["teng"], r["teng"].launches
        assert eng.megafront == eng.megadecode == (chain == "fused")
        if chain == "alternating":
            dec = r["decode"]
            assert 0 < dec < n and eng.paged_impl == impl
            want = {"fused_rms_norm": (2 * LAYERS + 1) * n,
                    ALT[impl]: LAYERS * dec}
            assert r["routes"]["paged_" + impl] == LAYERS * dec
        else:
            want = {k: (a * LAYERS + b) * n
                    for k, (a, b) in PER_STEP[chain].items()}
        if quant == "int4" and chain == "split":
            # every projection (the tied head stays the fp embedding)
            want["weight_only_linear"] = 7 * LAYERS * n
        for name, c in r["counts"].items():
            assert c == {"launches": 0, "plain_calls": want.get(name, 0)}, \
                name

    @pytest.mark.parametrize("quant", (None,) + QUANT)
    def test_engine_slab_and_bias_match_jax(self, runs, quant):
        r = runs[("fused", "intree", quant)]
        sfx = {"int8": "_q", "int4": "_q4"}.get(quant, "")
        keys = ["wqkv" + sfx, "bqkv"] + (["wqkv_s"] if quant else [])
        for jl, tl in zip(r["jeng"]._p["layers"], r["teng"]._p["layers"]):
            for k in keys:
                want = np.asarray(jl[k])
                assert tl[k].numpy().dtype == want.dtype, k
                np.testing.assert_array_equal(tl[k].numpy(), want, err_msg=k)
            for k in ("wq", "wk", "wv", "bq", "bk", "bv"):
                assert k + sfx not in tl and k not in tl

    def test_tokens_equal_solo_generate_cached(self, models, runs):
        _, tm, _ = models
        r = runs[("alternating", "intree", None)]
        for rid, (prompt, max_new, _) in enumerate(r["trace"]):
            gen, _ = tgen.generate_cached(tm, prompt[None],
                                          max_new_tokens=max_new,
                                          decode_strategy="greedy_search")
            np.testing.assert_array_equal(gen[0].numpy(), r["tres"][rid])
