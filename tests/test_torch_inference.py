"""The port's static inference path against the JAX package's: jit.save ->
inference.Predictor, with and without FLAGS_use_fusion_compiler, and the
static-program fusion pass jit.fusion_cc with its generic elementwise
kernel's plain version (the port of paddle_tpu/jit/fusion_cc.py and
csrc/fusion_pass.cc).

A seeded JAX LlamaForCausalLM (tiny: 2 layers, head_dim 64 on 2 query
heads and 1 KV head, so attention takes the flash route in both
packages) carries its weights into the port's model (extract_state ->
load_reference_state). Both packages save it at [2, 64] and serve it
through their Predictors: the logits agree within 2e-5 (f32; JAX at
"highest" matmul precision), flag or no flag. The pass's reports agree
pattern by pattern (rmsnorm 2L + 1, swiglu L) and each generic region's
program equals JAX's op for op, with one pinned difference (ROADMAP.md
queue C, C8): JAX also reports the region inside its jitted @silu helper,
a function its swiglu rewrites leave without a caller, so the region
never runs; core ATen has no helper function, so the port reports 4L
generic regions where JAX reports 4L + 1.

Then the cases of tests/test_fusion_cc.py (TestMatcher,
TestRewriteAndExecute, TestPredictorIntegration, TestGenericRegionFusion)
in torch, at their bars (generic 1e-6, rms and sdpa 2e-5, the full block
5e-5), each against the JAX function; generic_elementwise's plain version
against the JAX pass's interpreter `_run_generic_prog` over all 15 ops;
the Predictor's contract (handles, positional run, clone, deadline,
admission, concrete InputSpec, the device check, a failing pass that
raises, the card by default); and a canary on the core-ATen op names the
matchers key on."""

import collections
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import jit as jjit
from paddle_tpu.jit import extract_state
from paddle_tpu.jit import fusion_cc as jfusion_cc
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.static import InputSpec as JaxInputSpec

from paddle_tpu_torch import inference, jit, ops, resilience
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.flags import flags_guard
from paddle_tpu_torch.jit import fusion_cc
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.ops.elementwise import EW_OPS
from paddle_tpu_torch.static import InputSpec

TINY = dict(num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1)
L = TINY["num_hidden_layers"]
B, S = 2, 64
#: the JAX generic region of its @silu helper (C8)
SILU_PROG = ["negate", "exponential", "add", "divide", "multiply"]


def _cpu_config(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return cfg


def _run(pred, ids):
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(ids)
    pred.run()
    return pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(0).randint(0, 512, (B, S))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, ids):
    """The JAX model, its Predictors' logits (flag off / on), the flagged
    pass's report and rewritten text, and the saved program's text."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(**TINY))
    jm.eval()
    state = {k: np.asarray(v) for k, v in extract_state(jm).items()}
    prefix = str(tmp_path_factory.mktemp("jax") / "llama")
    with jax.default_matmul_precision("highest"):
        jjit.save(jm, prefix, input_spec=[JaxInputSpec([B, S], "int32")])
    out = {"state": state}
    try:
        for flag in (False, True):
            paddle.set_flags({"FLAGS_use_fusion_compiler": flag})
            pred = jinference.create_predictor(jinference.Config(prefix))
            h = pred.get_input_handle(pred.get_input_names()[0])
            h.copy_from_cpu(ids.astype(np.int32))
            pred.run()
            out[flag] = pred.get_output_handle(
                pred.get_output_names()[0]).copy_to_cpu()
            if flag:
                out["matches"] = pred._call.matches
                out["rewritten"] = pred._call.module_text
    finally:
        paddle.set_flags({"FLAGS_use_fusion_compiler": False})
    with open(prefix + ".stablehlo.txt") as f:
        out["saved_text"] = f.read()
    return out


@pytest.fixture(scope="module")
def port_side(tmp_path_factory, jax_side, ids):
    """The port's model with the JAX weights, saved; its Predictors'
    logits and launch counts (flag off / on) and the flagged report."""
    tm = LlamaForCausalLM(llama_tiny_config(**TINY), device="cpu")
    load_reference_state(tm, jax_side["state"])
    prefix = str(tmp_path_factory.mktemp("port") / "llama")
    jit.save(tm, prefix, input_spec=[InputSpec([B, S], "int64")])
    out = {"model": tm, "prefix": prefix}
    for flag in (False, True):
        with flags_guard(use_fusion_compiler=flag):
            pred = inference.create_predictor(_cpu_config(prefix))
        ops.reset_counts()
        out[flag] = _run(pred, ids)
        out[("counts", flag)] = {k: v["plain_calls"] for k, v in
                                 ops.launch_counts().items()
                                 if v["plain_calls"] or v["launches"]}
        out[("pred", flag)] = pred
    return out


def _by_pattern(matches):
    return dict(collections.Counter(m["pattern"] for m in matches))


# ---------------------------------------------------------------- Llama
class TestLlamaPredictorAgainstJax:
    @pytest.mark.parametrize("flag", [False, True])
    def test_logits_within_2e5(self, jax_side, port_side, flag):
        np.testing.assert_allclose(port_side[flag], jax_side[flag],
                                   rtol=2e-5, atol=2e-5)

    def test_flag_does_not_move_the_logits(self, port_side):
        np.testing.assert_allclose(port_side[True], port_side[False],
                                   rtol=2e-5, atol=2e-5)

    def test_report_counts_equal_jax_but_the_silu_helper(self, jax_side,
                                                         port_side):
        pred = port_side[("pred", True)]
        port = _by_pattern(pred.fused.matches)
        jax_ = _by_pattern(jax_side["matches"])
        assert port == {"rmsnorm": 2 * L + 1, "swiglu": L,
                        "generic": 4 * L}
        # C8: JAX's one extra region is its @silu helper's body
        assert jax_ == dict(port, generic=port["generic"] + 1)
        assert pred.fused.found == dict(port, sdpa=0)
        assert not any(pred.fused.refused.values())

    def test_silu_helper_region_never_runs(self, jax_side):
        """C8: the saved program calls @silu once a layer; the rewritten
        one, whose swiglu rewrites replaced those calls, calls it nowhere,
        so the generic kernel spliced into @silu never runs."""
        call = re.compile(r"call @silu\(")
        assert len(call.findall(jax_side["saved_text"])) == L
        assert call.findall(jax_side["rewritten"]) == []
        assert re.search(r"func\.func private @silu\(",
                         jax_side["rewritten"])
        gens = [[st["op"] for st in m["prog"]]
                for m in jax_side["matches"] if m["pattern"] == "generic"]
        assert gens.count(SILU_PROG) == 1

    def test_generic_programs_equal_jax(self, jax_side, port_side):
        def progs(matches):
            return [([st["op"] for st in m["prog"]], m["result_type"])
                    for m in matches if m["pattern"] == "generic"]
        jax_ = [p for p in progs(jax_side["matches"])
                if p[0] != SILU_PROG]
        port = progs(port_side[("pred", True)].fused.matches)
        assert port == jax_
        assert {tuple(p[0]) for p in port} == {
            ("multiply", "multiply", "subtract"),
            ("multiply", "multiply", "add")}

    def test_plain_calls_per_run(self, port_side):
        assert port_side[("counts", False)] == {"flash_sdpa": L}
        assert port_side[("counts", True)] == {
            "flash_sdpa": L, "fused_rms_norm": 2 * L + 1, "swiglu": L,
            "generic_elementwise": 4 * L}

    def test_saved_program_holds_the_flash_node(self, port_side):
        text = open(port_side["prefix"] + ".graph.txt").read()
        assert text.count("torch.ops.paddle_tpu_torch.flash_fwd") == L
        assert "_softmax" not in text

    def test_jit_load_roundtrip(self, port_side, ids):
        layer = jit.load(port_side["prefix"])
        np.testing.assert_array_equal(layer(ids).numpy(),
                                      port_side[False])
        assert layer.eval() is layer
        with pytest.raises(RuntimeError, match="inference-only"):
            layer.train()


# ---------------------------------------- tests/test_fusion_cc.py's cases
def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def _sdpa_t(q, k, v):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.125
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def _sdpa_j(q, k, v):
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * 0.125
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


def _rms_t(x, w):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * w


def _rms_j(x, w):
    x32 = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(x32), -1, keepdims=True)
    return (x32 * jax.lax.rsqrt(var + 1e-6)).astype(x.dtype) * w


def _jax(fn, *arrays):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in arrays)))


def _patterns(f):
    return sorted(m["pattern"] for m in f.matches)


class TestMatcher:
    def _qkv(self, dtype=torch.float32, H=4):
        g = torch.Generator().manual_seed(H)
        return [torch.randn(2, H, 64, 64, generator=g).to(dtype)
                for _ in range(3)]

    def test_finds_sdpa_with_scale(self):
        f = fusion_cc.fuse_compile(_sdpa_t, *self._qkv())
        assert _patterns(f) == ["sdpa"]
        assert f.matches[0]["scale"] == pytest.approx(0.125)
        assert len(f.matches[0]["operands"]) == 3

    def test_finds_bf16_sdpa_through_converts(self):
        def bf(q, k, v):
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.125
            p = torch.softmax(s.float(), -1).to(q.dtype)
            return torch.einsum("bhqk,bhkd->bhqd", p, v)
        f = fusion_cc.fuse_compile(bf, *self._qkv(torch.bfloat16, 2))
        assert _patterns(f) == ["sdpa"]

    def test_finds_matmul_sdpa(self):
        def mm(q, k, v):
            return torch.softmax(q @ k.transpose(-1, -2) * 0.125, -1) @ v
        qkv = self._qkv()
        f = fusion_cc.fuse_compile(mm, *qkv)
        assert _patterns(f) == ["sdpa"]
        torch.testing.assert_close(f(*qkv), mm(*qkv), rtol=2e-5,
                                   atol=2e-5)

    def test_finds_rmsnorm_with_eps(self):
        f = fusion_cc.fuse_compile(_rms_t, torch.ones(4, 256),
                                   torch.ones(256))
        assert _patterns(f) == ["rmsnorm"]
        assert f.matches[0]["eps"] == pytest.approx(1e-6, rel=1e-3)

    def test_escaping_interior_rejected(self):
        def leaky(q, k, v):
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.125
            p = torch.softmax(s, -1)
            return torch.einsum("bhqk,bhkd->bhqd", p, v), p
        f = fusion_cc.fuse_compile(leaky, *self._qkv(H=2))
        assert f.matches == [] and f.found["sdpa"] == 0

    def test_wrong_divisor_rejected(self):
        def bad(x, w):
            var = (x * x).sum(-1, keepdim=True) / 7.0
            return x * torch.rsqrt(var + 1e-6) * w
        f = fusion_cc.fuse_compile(bad, torch.ones(4, 256), torch.ones(256))
        assert "rmsnorm" not in _patterns(f)

    def test_plain_matmul_untouched(self):
        f = fusion_cc.fuse_compile(lambda a, b: a @ b, torch.ones(8, 8),
                                   torch.ones(8, 8))
        assert f.matches == []


class TestRewriteAndExecute:
    def test_sdpa_numerics_and_region_removed(self):
        rng = np.random.RandomState(0)
        q, k, v = (rng.standard_normal((2, 4, 64, 64)).astype(np.float32)
                   for _ in range(3))
        f = fusion_cc.fuse_compile(_sdpa_t, *_t(q, k, v))
        assert f.n_fused == 1
        np.testing.assert_allclose(f(*_t(q, k, v)).numpy(),
                                   _jax(_sdpa_j, q, k, v),
                                   rtol=2e-5, atol=2e-5)
        assert "_softmax" not in f.module_text
        assert "aten.bmm" not in f.module_text
        assert "_exec_sdpa_bmm" in f.module_text

    def test_rmsnorm_numerics(self):
        rng = np.random.RandomState(1)
        x = rng.standard_normal((4, 256)).astype(np.float32)
        w = rng.standard_normal((256,)).astype(np.float32)
        f = fusion_cc.fuse_compile(_rms_t, *_t(x, w))
        assert f.n_fused == 1
        np.testing.assert_allclose(f(*_t(x, w)).numpy(), _jax(_rms_j, x, w),
                                   rtol=2e-5, atol=2e-5)

    def test_swiglu_numerics(self):
        rng = np.random.RandomState(2)
        g, u = (rng.standard_normal((4, 256)).astype(np.float32)
                for _ in range(2))
        f = fusion_cc.fuse_compile(
            lambda a, b: torch.nn.functional.silu(a) * b, *_t(g, u))
        assert _patterns(f) == ["swiglu"]
        np.testing.assert_allclose(
            f(*_t(g, u)).numpy(),
            _jax(lambda a, b: jax.nn.silu(a) * b, g, u), rtol=2e-5,
            atol=2e-5)

    def test_full_block_fuses_all_three(self):
        def block_t(x, w, wg, wu):
            h = _rms_t(x, w)
            Bb, Ss, Hh = h.shape
            q = h.reshape(Bb, Ss, 2, Hh // 2).transpose(1, 2)
            s = torch.einsum("bhqd,bhkd->bhqk", q, q) * 0.3
            o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), q)
            o = o.transpose(1, 2).reshape(Bb, Ss, Hh)
            return torch.nn.functional.silu(o @ wg) * (o @ wu)

        def block_j(x, w, wg, wu):
            h = _rms_j(x, w)
            Bb, Ss, Hh = h.shape
            q = h.reshape(Bb, Ss, 2, Hh // 2).transpose(0, 2, 1, 3)
            s = jnp.einsum("bhqd,bhkd->bhqk", q, q) * 0.3
            o = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), q)
            o = o.transpose(0, 2, 1, 3).reshape(Bb, Ss, Hh)
            return jax.nn.silu(o @ wg) * (o @ wu)
        rng = np.random.RandomState(3)
        x = (rng.standard_normal((2, 64, 128)) * 0.3).astype(np.float32)
        w = rng.standard_normal((128,)).astype(np.float32)
        wg, wu = ((rng.standard_normal((128, 256)) * 0.1).astype(np.float32)
                  for _ in range(2))
        f = fusion_cc.fuse_compile(block_t, *_t(x, w, wg, wu))
        for need in ("rmsnorm", "sdpa", "swiglu"):
            assert need in _patterns(f), f.matches
        np.testing.assert_allclose(f(*_t(x, w, wg, wu)).numpy(),
                                   _jax(block_j, x, w, wg, wu),
                                   rtol=5e-5, atol=5e-5)

    def test_no_match_passes_through(self):
        a = torch.ones(4, 4)
        f = fusion_cc.fuse_compile(lambda x, y: torch.tanh(x) + y, a, a)
        assert f.n_fused == 0 and f.matches == []
        np.testing.assert_allclose(f(a, a).numpy(), np.tanh(1.0) + 1.0,
                                   rtol=1e-6)


class TestPredictorIntegration:
    def test_flag_gated_predictor_uses_the_pass(self, tmp_path):
        class TinyAttn(torch.nn.Module):
            def __init__(self):
                super().__init__()
                g = torch.Generator().manual_seed(5)
                self.q = torch.nn.Parameter(
                    torch.randn(64, 64, generator=g) * 0.125)

            def forward(self, x):
                Bb, Ss, Hh = x.shape
                q = (x @ self.q).reshape(Bb, Ss, 1, 64).transpose(1, 2)
                s = torch.einsum("bhqd,bhkd->bhqk", q, q) * 0.125
                o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), q)
                return o.reshape(Bb, Ss, Hh)

        layer = TinyAttn()
        prefix = str(tmp_path / "attn")
        jit.save(layer, prefix, input_spec=[InputSpec([2, 64, 64])])
        x = np.random.RandomState(0).standard_normal(
            (2, 64, 64)).astype(np.float32)
        with flags_guard(use_fusion_compiler=True):
            pred = inference.create_predictor(_cpu_config(prefix))
        assert pred.fused.n_fused >= 1, "the pass did not run"
        assert _patterns(pred.fused) == ["sdpa"]
        ops.reset_counts()
        out = _run(pred, x)
        assert ops.launch_counts()["flash_sdpa"]["plain_calls"] == 1
        with torch.no_grad():
            ref = layer(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


class TestGenericRegionFusion:
    """The JAX pass's generic regions (CINN generic-fusion parity), in
    torch: the port's program equals JAX's op for op (constants are
    operands there, immediates here) and the fused run equals JAX's
    within 1e-6."""

    def _x(self, seed=0):
        return np.random.RandomState(seed).randn(64, 128).astype(np.float32)

    def _jax_generic(self, fn, *arrays):
        """JAX's generic programs, with its lowering of sigmoid (negate,
        exponential, add 1, divide 1 by it) read as the one logistic
        that core ATen keeps."""
        text = jax.jit(fn).lower(*(jnp.asarray(a) for a in arrays)).as_text()
        out = []
        for m in jfusion_cc.analyze_text(text):
            if m["pattern"] != "generic":
                continue
            prog = " ".join(st["op"] for st in m["prog"])
            prog = prog.replace("negate exponential add divide", "logistic")
            out.append(prog.split())
        return out

    def _port_generic(self, f):
        return [[st["op"] for st in m["prog"]] for m in f.matches
                if m["pattern"] == "generic"]

    def test_unnamed_chain_matches_and_executes(self):
        def chain_t(a, b, c):
            return torch.exp(torch.tanh(a * b + c) * 0.5) - \
                torch.sqrt(torch.abs(b) + 1.0)

        def chain_j(a, b, c):
            return jnp.exp(jnp.tanh(a * b + c) * 0.5) - \
                jnp.sqrt(jnp.abs(b) + 1.0)
        x = self._x()
        f = fusion_cc.fuse_compile(chain_t, *_t(x, x, x))
        port = self._port_generic(f)
        assert port == self._jax_generic(chain_j, x, x, x)
        assert len(port[0]) >= 8
        assert [st["ins"][1] for st in f.matches[0]["prog"]
                if st["op"] == "multiply"][-1] == 0.5    # an immediate
        np.testing.assert_allclose(f(*_t(x, x, x)).numpy(),
                                   _jax(chain_j, x, x, x),
                                   rtol=1e-6, atol=1e-6)

    def test_second_unnamed_shape_min_maximum_mix(self):
        def chain_t(a, b):
            h = torch.maximum(a, b) * torch.minimum(a, -b)
            return torch.log(torch.abs(h) + 2.0) / (torch.tanh(b) + 3.0)

        def chain_j(a, b):
            h = jnp.maximum(a, b) * jnp.minimum(a, -b)
            return jnp.log(jnp.abs(h) + 2.0) / (jnp.tanh(b) + 3.0)
        x, y = self._x(1), self._x(2)
        f = fusion_cc.fuse_compile(chain_t, *_t(x, y))
        assert f.n_fused >= 1, f.matches
        assert self._port_generic(f) == self._jax_generic(chain_j, x, y)
        np.testing.assert_allclose(f(*_t(x, y)).numpy(),
                                   _jax(chain_j, x, y), rtol=1e-6,
                                   atol=1e-6)

    def test_multiuse_value_stays_external(self):
        def chain_t(a, b, c):
            t = torch.tanh(a * b + c)
            return t * torch.sigmoid(a) + torch.exp(c) * t

        def chain_j(a, b, c):
            t = jnp.tanh(a * b + c)
            return t * jax.nn.sigmoid(a) + jnp.exp(c) * t
        x = self._x(3)
        f = fusion_cc.fuse_compile(chain_t, *_t(x, x, x))
        assert self._port_generic(f) == self._jax_generic(chain_j, x, x, x)
        for m in f.matches:     # t, read twice, is no region's interior
            outs = [st["out"] for st in m["prog"][:-1]]
            assert "tanh" not in outs
        np.testing.assert_allclose(f(*_t(x, x, x)).numpy(),
                                   _jax(chain_j, x, x, x),
                                   rtol=1e-6, atol=1e-6)

    def test_named_patterns_not_eaten(self):
        """rmsnorm followed by more elementwise work: the named pattern
        claims its chain first, and no two matches overlap."""
        def f_t(x, w):
            y = _rms_t(x, w)
            return torch.tanh(y * 2.0) + torch.exp(-y) * 0.5
        x = torch.from_numpy(self._x(5))
        w = torch.ones(128)
        gm = fusion_cc.export_program(f_t, x, w).module()
        found = fusion_cc.analyze(gm)
        assert "rmsnorm" in [m.pattern for m in found]
        seen: set = set()
        for m in found:
            span = m.closed | {m.final}
            assert not span & seen, "overlapping matches"
            seen |= span
        f = fusion_cc.fuse_compile(f_t, x, w)
        torch.testing.assert_close(f(x, w), f_t(x, w), rtol=2e-5,
                                   atol=2e-5)

    def test_regions_past_the_gates_refused_and_counted(self):
        """The generic gate refuses (and counts) a region under 1024
        elements and one over the kernel's operand limit; both run as the
        program's own ops."""
        def nine(*xs):
            acc = xs[0] * xs[1]
            for x in xs[2:]:
                acc = acc * x
            return acc
        big = [torch.from_numpy(self._x(i)) for i in range(9)]
        small = [t[:4, :4] for t in big[:4]]
        for args in (big, small):
            f = fusion_cc.fuse_compile(nine, *args)
            assert f.found["generic"] == f.refused["generic"] == 1
            assert f.matches == []
            torch.testing.assert_close(f(*args), nine(*args))

    def test_small_region_not_matched(self):
        x = self._x(4)
        f = fusion_cc.fuse_compile(lambda a, b: a * b + 1.0, *_t(x, x))
        assert "generic" not in _patterns(f)
        assert f.found["generic"] == 0


# ------------------------------------------- the kernel's plain version
class TestGenericKernelPlain:
    """generic_elementwise's plain version (what a CPU tensor runs, and
    what chip_smoke.py holds the kernel against) against the JAX pass's
    interpreter, fusion_cc._run_generic_prog, on every opcode."""

    @pytest.mark.parametrize("op", EW_OPS)
    def test_each_op_against_run_generic_prog(self, op):
        unary = op in ("exponential", "log", "tanh", "logistic", "rsqrt",
                       "sqrt", "negate", "abs")
        rng = np.random.RandomState(EW_OPS.index(op))
        a = (rng.rand(64, 128) * 3 + 0.5).astype(np.float32)
        b = rng.randn(64, 128).astype(np.float32)
        prog = [{"op": op, "ins": ["#0"] if unary else ["#0", "#1"],
                 "out": "%0"},
                {"op": "multiply", "ins": ["%0", "#1"], "out": "%1"},
                {"op": "add", "ins": ["%1", "#0"], "out": "%2"}]
        ops.reset_counts()
        got = ops.generic_elementwise(prog, *_t(a, b))
        assert ops.launch_counts()["generic_elementwise"] == {
            "launches": 0, "plain_calls": 1}
        want = jfusion_cc._run_generic_prog(prog, [jnp.asarray(a),
                                                   jnp.asarray(b)])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    def test_broadcast_strided_operands_and_immediates(self):
        """The rope region's operands as the port reads them (two strided
        halves of x, [1, S, 1, D/2] tables) against JAX's full-shape
        operands; an immediate against JAX's constant operand."""
        rng = np.random.RandomState(7)
        x = rng.randn(2, 16, 4, 64).astype(np.float32)
        c, s = (rng.randn(1, 16, 1, 32).astype(np.float32)
                for _ in range(2))
        xt = torch.from_numpy(x)
        prog = [{"op": "multiply", "ins": ["#0", "#1"], "out": "%0"},
                {"op": "multiply", "ins": ["#2", "#3"], "out": "%1"},
                {"op": "subtract", "ins": ["%0", "%1"], "out": "%2"},
                {"op": "multiply", "ins": ["%2", 0.5], "out": "%3"}]
        got = ops.generic_elementwise(prog, xt[..., :32],
                                      torch.from_numpy(c), xt[..., 32:],
                                      torch.from_numpy(s))
        full = [np.broadcast_to(v, (2, 16, 4, 32)) for v in
                (x[..., :32], c, x[..., 32:], s)]
        jprog = prog[:3] + [{"op": "multiply", "ins": ["%2", "#4"],
                             "out": "%3"}]
        want = jfusion_cc._run_generic_prog(
            jprog, [jnp.asarray(v) for v in full]
            + [jnp.full((2, 16, 4, 32), 0.5, jnp.float32)])
        assert got.is_contiguous() and got.shape == (2, 16, 4, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    def test_bf16_rounds_each_instruction(self):
        """bf16: each instruction rounded to bf16 before the next, as the
        unfused ops round."""
        g = torch.Generator().manual_seed(3)
        a, b = (torch.randn(64, 128, generator=g).to(torch.bfloat16)
                for _ in range(2))
        prog = [{"op": "multiply", "ins": ["#0", "#1"], "out": "%0"},
                {"op": "add", "ins": ["%0", "#0"], "out": "%1"},
                {"op": "exponential", "ins": ["%1"], "out": "%2"}]
        assert torch.equal(ops.generic_elementwise(prog, a, b),
                           torch.exp(a * b + a))

    def test_refusals(self):
        a = torch.ones(4, 4)
        with pytest.raises(ValueError, match="unknown op"):
            ops.generic_elementwise([{"op": "cosine", "ins": ["#0"],
                                      "out": "%0"}], a)
        with pytest.raises(ValueError, match="not defined"):
            ops.generic_elementwise([{"op": "add", "ins": ["#0", "%9"],
                                      "out": "%0"}], a)
        with pytest.raises(TypeError, match="one dtype"):
            ops.generic_elementwise([{"op": "add", "ins": ["#0", "#1"],
                                      "out": "%0"}], a, a.double())
        with pytest.raises(ValueError, match="no kernel for device"):
            ops.generic_elementwise([{"op": "abs", "ins": ["#0"],
                                      "out": "%0"}],
                                    torch.empty(4, device="meta"))


# ------------------------------------------------ the Predictor contract
class TestPredictorContract:
    def test_handles_and_positional_run(self, port_side, ids):
        pred = port_side[("pred", False)]
        assert pred.get_input_names() == ["x0"]
        assert pred.get_output_names() == ["out0"]
        assert pred.get_input_handle("x0").shape() == [B, S]
        out = pred.run([ids])
        assert isinstance(out, list) and len(out) == 1
        np.testing.assert_array_equal(out[0], port_side[False])
        with pytest.raises(ValueError, match="takes 1"):
            pred.run([ids, ids])

    def test_missing_artifact(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="jit.save"):
            inference.create_predictor(_cpu_config(str(tmp_path / "no")))

    def test_clone_shares_the_rewrite_with_fresh_handles(self, port_side,
                                                         ids):
        pred = port_side[("pred", True)]
        twin = pred.clone()
        assert twin.fused is pred.fused
        assert twin.get_input_handle("x0") is not \
            pred.get_input_handle("x0")
        with pytest.raises(RuntimeError, match="not computed"):
            twin.get_output_handle("out0").copy_to_cpu()
        np.testing.assert_array_equal(_run(twin, ids), port_side[True])

    def test_deadline_returns_a_falsy_timeout(self, port_side, ids):
        pred = port_side[("pred", False)].clone()
        misses = resilience.deadline_misses()
        res = pred.run([ids], deadline_s=1e-9)
        assert isinstance(res, resilience.TimeoutResult) and not res
        assert resilience.deadline_misses() == misses + 1

    def test_admission_refuses_when_full(self, port_side, ids):
        cfg = _cpu_config(port_side["prefix"])
        cfg.set_admission(1, queue_timeout_s=0.0)
        pred = inference.create_predictor(cfg)
        twin = pred.clone()
        assert twin._gate is pred._gate
        rejects = resilience.admission_rejects()
        with pred._gate.admit():
            with pytest.raises(resilience.Overloaded):
                twin.run([ids])
        assert resilience.admission_rejects() == rejects + 1
        np.testing.assert_array_equal(twin.run([ids])[0], port_side[False])

    def test_input_spec_needs_concrete_dims(self, tmp_path):
        spec = InputSpec([None, 64], "int64")
        assert spec.shape == (-1, 64) and spec.dtype == torch.int64
        model = torch.nn.Linear(4, 4)
        with pytest.raises(ValueError, match="concrete dims"):
            jit.save(model, str(tmp_path / "m"),
                     input_spec=[InputSpec([-1, 4])])

    def test_save_restores_every_mode(self, tmp_path):
        model = torch.nn.Sequential(torch.nn.Linear(4, 4),
                                    torch.nn.Dropout(0.5))
        model.train()
        model[1].eval()             # a deliberately frozen submodule
        jit.save(model, str(tmp_path / "m"), input_spec=[InputSpec([2, 4])])
        assert model.training and model[0].training
        assert not model[1].training
        for ext in (".pdparams", ".pt2", ".graph.txt"):
            assert (tmp_path / ("m" + ext)).is_file()
        assert jit.artifact_device(str(tmp_path / "m.pt2")) == "cpu"

    def test_device_mismatch_raises(self, port_side, monkeypatch):
        monkeypatch.setattr(jit, "artifact_device", lambda path: "cuda")
        with pytest.raises(ValueError, match="exported on cuda"):
            inference.create_predictor(_cpu_config(port_side["prefix"]))

    def test_the_card_by_default(self, port_side, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            inference.create_predictor(inference.Config(
                port_side["prefix"]))

    def test_a_failing_pass_raises(self, port_side, monkeypatch):
        def broken(*a, **k):
            raise RuntimeError("pass failed")
        monkeypatch.setattr(fusion_cc, "fuse_compile", broken)
        with flags_guard(use_fusion_compiler=True):
            with pytest.raises(RuntimeError, match="pass failed"):
                inference.create_predictor(
                    _cpu_config(port_side["prefix"]))


# -------------------------------------------------------- format canary
class TestFormatCanary:
    """The matchers key on core ATen's op names: a decomposition change
    must fail here, loudly, not leave the pass finding nothing."""

    def test_matched_ops_appear_in_a_fresh_export(self):
        cfg = llama_tiny_config(**dict(TINY, num_hidden_layers=1))
        model = LlamaForCausalLM(cfg, device="cpu", dtype=torch.bfloat16)
        ep = fusion_cc.export_program(model, torch.zeros(1, 64,
                                                         dtype=torch.int64))
        got = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
        for name in ("aten._to_copy.default", "aten.mean.dim",
                     "aten.rsqrt.default", "aten.sigmoid.default",
                     "aten.mul.Tensor", "aten.sub.Tensor",
                     "aten.slice.Tensor",
                     "paddle_tpu_torch.flash_fwd.default"):
            assert name in got, (name, sorted(got))
        ep = fusion_cc.export_program(_sdpa_t, *TestMatcher()._qkv(H=2))
        got = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
        assert {"aten._softmax.default", "aten.bmm.default"} <= got
