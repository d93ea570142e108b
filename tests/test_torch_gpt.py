"""The port's GPT slice against the JAX package on the CPU.

- `fused_layer_norm` (`TestLayerNormParity`): the port's wrapper on CPU
  tensors (its plain version) against the JAX Pallas kernel (interpret
  mode on the CPU, as the JAX package's own tests run it) and the JAX
  reference, f32 at 2e-5 and bf16 at 2e-2, rows with a large mean
  included; nn.LayerNorm and functional.gelu against the JAX layers;
- the megakernels' gpt sites (`TestGptSitesParity`): fused_oproj_norm
  with norm="layer" and the o-proj bias, fused_ffn with act="gelu" and
  b1 / b2, against the JAX kernels and references, f32 at 2e-5, int8
  too, and int4 for the o-proj (its JAX reference at the JAX tests' 1e-4
  for the even / odd split); the int4 gelu FFN raises in both packages;
- a seeded JAX GPTForCausalLM (gpt_tiny_config at hidden 128, 2 heads of
  64, 2 layers, random biases and LayerNorm affines) carried into the
  port's model by extract_state -> numpy -> load_reference_state (key
  for key, the tied head included): forward logits within 2e-5,
  `generate` and `generate_cached` greedy tokens identical (scores within
  1e-5, JAX at "highest" matmul precision); quantized GPT raises in both;
- `ServingEngine` greedy tokens identical to the JAX engine's over the
  seeded join/leave trace of test_torch_llama_serving.py (its three
  requests that share a prefix and two seeded ones) on the fused
  chain, the split chain and the alternating path under both paged
  impls, with every kernel wrapper's calls per step: fused_layer_norm
  layers + 1 (fused) or 2 * layers + 1 (split, and every alternating
  launch), fused_oproj_norm and fused_ffn layers each on the fused
  chain."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu.jit import extract_state
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny_config as jax_tiny_config
from paddle_tpu.ops import fused as jfused
from paddle_tpu.ops import pallas_megadecode as jmd
from paddle_tpu.ops import references as jrefs
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.flags import flags_guard
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny_config
from paddle_tpu_torch.ops import paged_attention as routes
from paddle_tpu_torch.serving import ServingEngine

from test_torch_llama_serving import ENGINE_KW, _drive, _serving_trace

TINY = dict(hidden_size=128, num_attention_heads=2)
LAYERS = 2
NEW = 6
INT8, INT4 = "weight_only_int8", "weight_only_int4"


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, tol, *refs):
    for ref in refs:
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(ref, np.float32), atol=tol,
                                   rtol=tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


class TestLayerNormParity:
    @pytest.mark.parametrize("shape", [(7, 64), (2, 5, 256), (3, 1000)])
    def test_matches_jax(self, shape):
        rng = np.random.RandomState(0)
        x = _rand(rng, *shape)
        x[0] += 30.0                   # a row whose mean dwarfs its spread
        w, b = _rand(rng, shape[-1]), _rand(rng, shape[-1])
        before = ops.fused_layer_norm.plain_calls
        got = ops.fused_layer_norm(_t(x), _t(w), _t(b), 1e-5)
        assert ops.fused_layer_norm.plain_calls == before + 1
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        jx = [jnp.asarray(v) for v in (x, w, b)]
        _close(got.numpy(), 2e-5, jfused.fused_layer_norm(*jx, 1e-5),
               jrefs.layer_norm_reference(*jx, 1e-5))

    @pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
    def test_bf16(self, w_dtype):
        rng = np.random.RandomState(1)
        x, w, b = _rand(rng, 4, 128), _rand(rng, 128), _rand(rng, 128)
        got = ops.fused_layer_norm(_t(x).bfloat16(), _t(w).to(w_dtype),
                                   _t(b).to(w_dtype))
        jw = jnp.bfloat16 if w_dtype == torch.bfloat16 else jnp.float32
        want = jfused.fused_layer_norm(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w, jw), jnp.asarray(b, jw))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=2e-2,
                                   rtol=2e-2)

    def test_registered(self):
        e = ops.oracles()["fused_layer_norm"]
        assert e.kernel is ops.fused_layer_norm
        assert e.reference is ops.layer_norm_reference

    def test_layers_against_jax(self):
        from paddle_tpu import nn as jnn
        from paddle_tpu.nn import functional as jF
        from paddle_tpu_torch import nn as tnn
        rng = np.random.RandomState(2)
        x = _rand(rng, 3, 5, 16) + 4.0
        jl = jnn.LayerNorm(16, 1e-5)
        state = {"weight": _rand(rng, 16), "bias": _rand(rng, 16)}
        jl.weight._data = jnp.asarray(state["weight"])
        jl.bias._data = jnp.asarray(state["bias"])
        tl = tnn.LayerNorm(16, 1e-5, device="cpu")
        load_reference_state(tl, state)
        _close(tl(_t(x)).detach().numpy(), 2e-5,
               np.asarray(jl(paddle.to_tensor(x))._data))
        for approx in (True, False):
            _close(tnn.functional.gelu(_t(x), approximate=approx).numpy(),
                   2e-5, np.asarray(jF.gelu(paddle.to_tensor(x),
                                            approximate=approx)._data))


class TestGptSitesParity:
    @pytest.mark.parametrize("algo", [None, INT8, INT4])
    @pytest.mark.parametrize("T,Ko,H", [(7, 48, 40), (12, 136, 24)])
    def test_oproj_layer_norm(self, algo, T, Ko, H):
        rng = np.random.RandomState(3)
        o, x = _rand(rng, T, Ko), _rand(rng, T, H) + 5.0
        w = _rand(rng, Ko, H, scale=Ko ** -0.5)
        b, nw, nb = _rand(rng, H), _rand(rng, H), _rand(rng, H)
        s = None
        if algo:
            qw, s = ops.weight_quantize(_t(w), algo)
            w, s = qw.numpy(), s.numpy()
        jargs = [_j(v) for v in (o, x, w, s, b, nw, nb)]
        jkw = dict(eps=1e-5, norm="layer", algo=algo)
        want = [jmd.fused_oproj_norm(*jargs, **jkw),
                jrefs.oproj_norm_reference(*jargs, **jkw)]
        before = ops.fused_oproj_norm.plain_calls
        got = ops.fused_oproj_norm(*map(_t, (o, x, w, s, b, nw, nb)),
                                   **jkw)
        assert ops.fused_oproj_norm.plain_calls == before + 1
        for i, g in enumerate(got):
            _close(g.numpy(), 2e-5, want[0][i])
            # int4: the JAX reference takes one product over the whole
            # dequantized weight, the kernels the even / odd split (the
            # JAX tests' own bar for it)
            np.testing.assert_allclose(
                g.numpy(), np.asarray(want[1][i]),
                **(dict(atol=1e-4, rtol=1e-5) if algo == INT4
                   else dict(atol=2e-5, rtol=2e-5)))

    @pytest.mark.parametrize("algo", [None, INT8])
    @pytest.mark.parametrize("T,H,I", [(7, 40, 72), (12, 24, 136)])
    def test_ffn_gelu(self, algo, T, H, I):
        rng = np.random.RandomState(4)
        h, x = _rand(rng, T, H), _rand(rng, T, H)
        wi = _rand(rng, H, I, scale=H ** -0.5)
        wf = _rand(rng, I, H, scale=I ** -0.5)
        b1, b2 = _rand(rng, I), _rand(rng, H)
        si = sf = None
        if algo:
            (wi, si), (wf, sf) = ((q.numpy(), s_.numpy()) for q, s_ in (
                ops.weight_quantize(_t(w_), algo) for w_ in (wi, wf)))
        args = (h, x, wi, si, None, None, wf, sf, b1, b2)
        want = [jmd.fused_ffn(*map(_j, args), act="gelu", algo=algo),
                jrefs.megadecode_ffn_reference(*map(_j, args), act="gelu",
                                               algo=algo)]
        before = ops.fused_ffn.plain_calls
        got = ops.fused_ffn(*map(_t, args), act="gelu", algo=algo)
        assert ops.fused_ffn.plain_calls == before + 1
        _close(got.numpy(), 2e-5, *want)
        # the up matrix is not read: any wu gives the same result
        again = ops.fused_ffn(*map(_t, args[:4]), _t(wi), _t(si),
                              *map(_t, args[6:]), act="gelu", algo=algo)
        torch.testing.assert_close(again, got, rtol=0, atol=0)

    def test_int4_gelu_raises_in_both(self):
        rng = np.random.RandomState(5)
        h = _rand(rng, 3, 8)
        q, s = ops.weight_quantize(_t(_rand(rng, 8, 16)), INT4)
        qd, sd = ops.weight_quantize(_t(_rand(rng, 16, 8)), INT4)
        with pytest.raises(NotImplementedError, match="swiglu-only"):
            jmd.fused_ffn(_j(h), _j(h), _j(q.numpy()), _j(s.numpy()), None,
                          None, _j(qd.numpy()), _j(sd.numpy()), act="gelu",
                          algo=INT4)
        with pytest.raises(NotImplementedError, match="swiglu-only"):
            ops.fused_ffn(_t(h), _t(h), q, s, None, None, qd, sd,
                          act="gelu", algo=INT4)


@pytest.fixture(scope="module")
def models():
    """The seeded JAX GPT with random biases and LayerNorm affines (its
    initializers leave them at 0 and 1), and the port's model carrying
    its weights."""
    paddle.seed(0)
    jm = JaxGPT(jax_tiny_config(**TINY))
    jm.eval()
    rng = np.random.RandomState(6)
    for name, p in jm.named_parameters():
        if name.endswith("bias") or ".ln_" in name:
            shape = tuple(p._data.shape)
            base = 1.0 if name.endswith("weight") else 0.0
            p._data = jnp.asarray(base + 0.1 * rng.randn(*shape),
                                  jnp.float32)
    state = {k: np.asarray(v) for k, v in extract_state(jm).items()}
    tm = GPTForCausalLM(gpt_tiny_config(**TINY), device="cpu")
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
    def test_state_keys_match(self, models):
        jm, tm, state = models
        assert set(tm.state_dict()) == set(state)
        assert tm.lm_head is None and jm.lm_head is None     # tied head
        for k in ("gpt.embed_positions.weight", "gpt.h.1.ln_2.bias",
                  "gpt.h.0.attn.qkv.bias", "gpt.h.1.mlp.fc_out.weight",
                  "gpt.ln_f.weight"):
            np.testing.assert_array_equal(tm.state_dict()[k].numpy(),
                                          state[k])

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
        ops.reset_counts()
        gen, sc = getattr(tgen, name)(tm, prompts, **kw)
        np.testing.assert_array_equal(gen.numpy(), want_gen)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-5)
        # the prompt's attention takes the flash route: once a layer per
        # forward of `generate`, the prefill of the cached path
        calls = NEW if name == "generate" else 1
        assert ops.launch_counts()["flash_sdpa"]["plain_calls"] == \
            calls * LAYERS

    @pytest.mark.parametrize("kw", [dict(weight_only_int8=True),
                                    dict(weight_only_quant="int4")])
    def test_quantized_gpt_raises_in_both(self, models, prompts, kw):
        jm, tm, _ = models
        with pytest.raises(NotImplementedError, match="GPT family is fp"):
            jgen.generate_cached(jm, paddle.to_tensor(prompts),
                                 max_new_tokens=2, **kw)
        with pytest.raises(NotImplementedError, match="GPT family is fp"):
            tgen.generate_cached(tm, prompts, max_new_tokens=2, **kw)
        with pytest.raises(NotImplementedError, match="GPT family is fp"):
            ServingEngine(tm, device="cpu", **kw)

    def test_decode_tree_matches_jax(self, models):
        jm, tm, _ = models
        jp, tp = jgen._decode_params(jm), tgen._decode_params(tm)
        assert tp["family"] == jp["family"] == "gpt"
        for a, b in [(jp, tp)] + list(zip(jp["layers"], tp["layers"])):
            keys = {k for k in b if k not in ("cfg", "family", "layers")}
            assert keys == {k for k in a
                            if k not in ("cfg", "family", "layers")}
            for k in keys:
                if b[k] is None:
                    assert a[k] is None, k
                else:
                    np.testing.assert_array_equal(b[k].numpy(),
                                                  np.asarray(a[k]))


CHAINS = {"fused": {}, "split": dict(megafront=False, megadecode=False)}
#: kernel-wrapper calls per layer and per step (the final norm) on each
#: chain of the unified step
PER_STEP = {
    "fused": {"fused_layer_norm": (1, 1), "fused_qkv_rope_append": (1, 0),
              "ragged_paged_attention": (1, 0), "fused_oproj_norm": (1, 0),
              "fused_ffn": (1, 0)},
    "split": {"fused_layer_norm": (2, 1), "fused_rope_append": (1, 0),
              "ragged_paged_attention": (1, 0)}}
ALT = {"intree": "paged_decode_attention_v2",
       "intree_v1": "paged_decode_attention"}


def _run(models, chain, impl, jax_runs):
    """Both engines over the seeded serving trace on `chain` ("fused",
    "split" or "alternating" under FLAGS_paged_impl `impl`); the port's
    counts, launches and decode launches. The JAX engine's run is shared
    by the runs that differ only on the port's side (its paged impl)."""
    jm, tm, _ = models
    trace = _serving_trace(jm.config.vocab_size, seeded=2)
    kw = dict(CHAINS.get(chain, dict(ragged=False)), **ENGINE_KW)
    if chain not in jax_runs:
        jeng = JaxEngine(jm, enable_prefix_cache=False, **kw)
        jax_runs[chain] = jeng, _drive(jeng, trace)[0]
    jeng, jres = jax_runs[chain]
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
    tres, treqs = _drive(teng, trace)
    return dict(jres=jres, tres=tres, treqs=treqs, teng=teng, jeng=jeng,
                trace=trace, counts=ops.launch_counts(),
                routes=dict(routes.route_counts), decode=len(decode))


RUNS = [("fused", "intree"), ("split", "intree"),
        ("alternating", "intree"), ("alternating", "intree_v1")]


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
        chain, impl = run
        r = runs[run]
        eng, n = r["teng"], r["teng"].launches
        assert eng.megafront == eng.megadecode == (chain == "fused")
        if chain == "alternating":
            dec = r["decode"]
            assert 0 < dec < n and eng.paged_impl == impl
            want = {"fused_layer_norm": (2 * LAYERS + 1) * n,
                    ALT[impl]: LAYERS * dec}
            assert r["routes"]["paged_" + impl] == LAYERS * dec
        else:
            want = {k: (a * LAYERS + b) * n
                    for k, (a, b) in PER_STEP[chain].items()}
        for name, c in r["counts"].items():
            assert c == {"launches": 0, "plain_calls": want.get(name, 0)}, \
                name

    def test_front_half_launches_as_jax(self, runs):
        for chain, want in (("fused", 2), ("split", 3)):
            r = runs[(chain, "intree")]
            assert r["teng"].front_half_launches == \
                r["jeng"].front_half_launches == want
            assert r["teng"].back_half_launches == \
                r["jeng"].back_half_launches

    def test_pools_are_mha_and_prefix_shared(self, models, runs):
        _, tm, _ = models
        r = runs[("fused", "intree")]
        kp = r["teng"]._pools[0][0]
        assert kp.shape[0] == tm.config.num_attention_heads
        assert r["treqs"][1].shared_tokens == 6
        st = r["teng"].allocator.stats()
        assert st["sequences"] == 0 and st["pages_used"] == 0

    def test_tokens_equal_solo_generate_cached(self, models, runs):
        _, tm, _ = models
        r = runs[("fused", "intree")]
        for rid, (prompt, max_new, _) in enumerate(r["trace"]):
            gen, _ = tgen.generate_cached(tm, prompt[None],
                                          max_new_tokens=max_new,
                                          decode_strategy="greedy_search")
            np.testing.assert_array_equal(gen[0].numpy(), r["tres"][rid])
