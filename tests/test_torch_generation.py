"""The port's `generate` and `generate_cached` against the JAX package.

A seeded JAX LlamaForCausalLM (tiny config: head_dim 64, 2 query heads
on 1 KV head) carries its weights into the port's model (extract_state
-> numpy -> load_reference_state). Both packages then generate from the
same prompts: greedy tokens identical, the chosen tokens' log-probs
within 1e-5 (f32; the two frameworks sum in different orders; JAX at
"highest" matmul precision). `_filter_logits` is held to JAX's on seeded
logits. Sampled tokens cannot match JAX's random bits (jax.random keys
against a torch.Generator): sampling is checked for reproducibility
under one seed, for validity, and top_k=1 against greedy.
`generate_cached` with weight-only int8 and int4 weights
(`TestQuantizedAgainstJax`): greedy tokens identical to JAX's, scores
within 1e-5; the int4 run's projections and head go through
weight_only_linear; conflicting quant knobs raise as in JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu.jit import extract_state
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import resilience
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.ops import flash_attention as attn

TINY = dict(num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1)
NEW = 6


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(**TINY))
    jm.eval()
    state = {k: np.asarray(v) for k, v in extract_state(jm).items()}
    tm = LlamaForCausalLM(llama_tiny_config(**TINY), device="cpu")
    load_reference_state(tm, state)
    return jm, tm


@pytest.fixture(scope="module")
def prompts():
    return np.random.RandomState(3).randint(0, 512, (2, 7)).astype(np.int32)


def _jax_run(fn, jm, ids, **kw):
    with jax.default_matmul_precision("highest"):
        gen, sc = fn(jm, paddle.to_tensor(ids), **kw)
    return np.asarray(gen._data), np.asarray(sc._data)


@pytest.fixture(scope="module")
def jax_greedy(models, prompts):
    jm, _ = models
    kw = dict(max_new_tokens=NEW, decode_strategy="greedy_search")
    return {"generate": _jax_run(jgen.generate, jm, prompts, **kw),
            "generate_cached": _jax_run(jgen.generate_cached, jm, prompts,
                                        **kw)}


class TestGreedyAgainstJax:
    @pytest.mark.parametrize("name", ["generate", "generate_cached"])
    def test_tokens_identical_scores_within_1e5(self, models, prompts,
                                                jax_greedy, name):
        _, tm = models
        attn.reset_route_counts()
        gen, sc = getattr(tgen, name)(tm, prompts, max_new_tokens=NEW,
                                      decode_strategy="greedy_search")
        assert gen.dtype == torch.int32 and tuple(gen.shape) == (2, NEW)
        want_gen, want_sc = jax_greedy[name]
        np.testing.assert_array_equal(gen.numpy(), want_gen)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-5)
        # the prompt's attention took the flash route (the plain version
        # on the CPU): every step of `generate`, the prefill of the cached
        # path, once a layer
        calls = NEW if name == "generate" else 1
        assert attn.route_counts["flash"] == calls * TINY["num_hidden_layers"]

    def test_cached_equals_buffer_model(self, models, prompts):
        _, tm = models
        a = tgen.generate(tm, prompts, max_new_tokens=NEW,
                          decode_strategy="greedy_search")
        b = tgen.generate_cached(tm, prompts, max_new_tokens=NEW,
                                 decode_strategy="greedy_search")
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
        torch.testing.assert_close(a[1], b[1], rtol=1e-5, atol=1e-5)

    def test_eos_pads_like_jax(self, models, prompts, jax_greedy):
        jm, tm = models
        eos = int(jax_greedy["generate_cached"][0][0, 1])
        kw = dict(max_new_tokens=NEW, decode_strategy="greedy_search",
                  eos_token_id=eos, pad_token_id=-1)
        want_gen, want_sc = _jax_run(jgen.generate_cached, jm, prompts, **kw)
        gen, sc = tgen.generate_cached(tm, prompts, **kw)
        np.testing.assert_array_equal(gen.numpy(), want_gen)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5, rtol=1e-5)
        assert (gen.numpy()[0, 2:] == -1).all() and (sc.numpy()[0, 2:] == 0).all()
        gen_b, _ = tgen.generate(tm, prompts, **kw)
        np.testing.assert_array_equal(gen_b.numpy(), want_gen)

    @pytest.mark.parametrize("name,completed", [("generate", 0),
                                                ("generate_cached", 1)])
    def test_deadline_returns_a_timeout_result(self, models, prompts, name,
                                               completed):
        _, tm = models
        misses = resilience.deadline_misses()
        res = getattr(tgen, name)(tm, prompts, max_new_tokens=NEW,
                                  decode_strategy="greedy_search",
                                  deadline_s=1e-9)
        assert isinstance(res, resilience.TimeoutResult) and not res
        assert res.kind == name and res.completed == completed
        gen, sc = res.partial
        assert tuple(gen.shape) == (2, NEW) and (gen[:, completed:] == 0).all()
        assert resilience.deadline_misses() == misses + 1

    def test_context_past_the_rope_table_raises(self, models):
        _, tm = models
        with pytest.raises(ValueError, match="max_position_embeddings"):
            tgen.generate_cached(tm, np.zeros((1, 250), np.int32),
                                 max_new_tokens=10)

    def test_other_families_name_their_item(self):
        # a MoE / MLA model (backbone `model`); gpt and qwen2 are ported
        class Moe(torch.nn.Module):
            model = object()
        with pytest.raises(NotImplementedError, match="queue A item 5"):
            tgen.generate_cached(Moe(), np.zeros((1, 3), np.int32))


@pytest.fixture(scope="module")
def jax_quant(models, prompts):
    jm, _ = models
    kw = dict(max_new_tokens=NEW, decode_strategy="greedy_search")
    return {q: _jax_run(jgen.generate_cached, jm, prompts,
                        weight_only_quant=q, **kw) for q in ("int8", "int4")}


class TestQuantizedAgainstJax:
    @pytest.mark.parametrize("quant", ["int8", "int4"])
    def test_generate_cached_tokens_identical(self, models, prompts,
                                              jax_quant, quant):
        from paddle_tpu_torch import ops
        _, tm = models
        ops.reset_counts()
        gen, sc = tgen.generate_cached(tm, prompts, max_new_tokens=NEW,
                                       decode_strategy="greedy_search",
                                       weight_only_quant=quant)
        want_gen, want_sc = jax_quant[quant]
        np.testing.assert_array_equal(gen.numpy(), want_gen)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-5)
        # one prefill and NEW - 1 decode calls, each 7 projections a layer
        # and the head; int8 products are h @ (q * s), no kernel
        L = TINY["num_hidden_layers"]
        wol = (7 * L + 1) * NEW if quant == "int4" else 0
        assert ops.launch_counts()["weight_only_linear"] == {
            "launches": 0, "plain_calls": wol}

    def test_int8_bool_equals_int8_knob(self, models, prompts, jax_quant):
        _, tm = models
        gen, _ = tgen.generate_cached(tm, prompts, max_new_tokens=NEW,
                                      decode_strategy="greedy_search",
                                      weight_only_int8=True)
        np.testing.assert_array_equal(gen.numpy(), jax_quant["int8"][0])

    @pytest.mark.parametrize("kw,match", [
        (dict(weight_only_int8=True, weight_only_quant="int4"),
         "conflicting quant knobs"),
        (dict(weight_only_quant="int2"), "expected 'int8' or 'int4'")])
    def test_bad_knobs_raise_like_jax(self, models, prompts, kw, match):
        jm, tm = models
        with pytest.raises(ValueError, match=match):
            jgen.generate_cached(jm, paddle.to_tensor(prompts),
                                 max_new_tokens=2, **kw)
        with pytest.raises(ValueError, match=match):
            tgen.generate_cached(tm, prompts, max_new_tokens=2, **kw)


class TestSampling:
    @pytest.mark.parametrize("top_k,top_p,temperature", [
        (8, None, 1.0), (None, 0.7, 1.0), (None, None, 0.6), (5, 0.9, 1.3)])
    def test_filter_logits_matches_jax(self, top_k, top_p, temperature):
        logits = np.random.RandomState(4).randn(3, 64).astype(np.float32) * 3
        want = np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k,
                                              top_p, temperature))
        got = tgen._filter_logits(torch.from_numpy(logits), top_k, top_p,
                                  temperature).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got[~np.isinf(got)],
                                   want[~np.isinf(want)], rtol=1e-6)

    @pytest.mark.parametrize("name", ["generate", "generate_cached"])
    def test_seeded_generator_reproducible_and_valid(self, models, prompts,
                                                     name):
        _, tm = models
        fn = getattr(tgen, name)
        kw = dict(max_new_tokens=NEW, decode_strategy="sampling", top_k=8,
                  temperature=0.9)
        g1, s1 = fn(tm, prompts, generator=torch.Generator().manual_seed(5),
                    **kw)
        g2, s2 = fn(tm, prompts, generator=torch.Generator().manual_seed(5),
                    **kw)
        torch.testing.assert_close(g1, g2, rtol=0, atol=0)
        torch.testing.assert_close(s1, s2, rtol=0, atol=0)
        assert int(g1.min()) >= 0 and int(g1.max()) < 512
        assert bool(torch.isfinite(s1).all()) and bool((s1 <= 1e-6).all())

    def test_top_k_1_equals_greedy(self, models, prompts):
        _, tm = models
        greedy, _ = tgen.generate_cached(tm, prompts, max_new_tokens=NEW,
                                         decode_strategy="greedy_search")
        k1, _ = tgen.generate_cached(tm, prompts, max_new_tokens=NEW,
                                     decode_strategy="sampling", top_k=1,
                                     generator=torch.Generator()
                                     .manual_seed(6))
        torch.testing.assert_close(k1, greedy, rtol=0, atol=0)
        zero_t, _ = tgen.generate(tm, prompts, max_new_tokens=NEW,
                                  temperature=0.0)
        torch.testing.assert_close(zero_t, greedy, rtol=0, atol=0)

    def test_bad_strategy_raises(self, models, prompts):
        with pytest.raises(ValueError, match="decode_strategy"):
            tgen.generate_cached(models[1], prompts, decode_strategy="beam")
