"""The port's Llama training path against the JAX package on the CPU.

A tiny Llama (2 layers, hidden 128, 2 query heads and 1 KV head of 64, so
attention takes the flash route with GQA; B 2, S 16) is drawn by the JAX
package under ``paddle.seed(5)`` and carried into the port by name
(`load_reference_state`, `pretrain_state_dict`). Then:

- `LlamaForCausalLM.forward`: logits and mean token loss in f32 at 1e-5,
  with labels and with a bool key-padding mask (the port routes it
  through the flash wrapper's segment ids, JAX through its composite);
- `FunctionalAdamW.update` over 3 steps, clipping on, f32 and bf16
  moments, a decay mask: master weights at 1e-6, f32 moments at 1e-6,
  bf16 moments within one bf16 ulp (8e-3 relative; an f32 last-bit
  difference may round the other way), grad norms at 1e-6;
- a 3-step `build_llama_pretrain_step` trajectory on three seeded
  batches against the JAX step on a one-device mesh: in f32, losses and
  grad norms at 1e-5 and master weights at 2e-5 absolute (three AdamW
  steps of lr 3e-4 from the same weights); in bf16 compute (f32 master,
  the two frameworks round the bf16 products at other places) losses at
  2e-3 and grad norms at 2e-2 relative, and 99% of the master weights
  at 1e-4 (where a bf16 gradient is near zero, Adam's per-element step
  may take the other sign), on two weight seeds;
- ``remat="full"`` and ``"dots"`` giving the losses of ``"none"``;
- the LlamaConfig knobs turned on: ``use_flash_attention=False`` (the
  dense composite) against JAX's logits and loss, and ``recompute=True``
  (each layer's forward runs again in the backward) against the
  gradients of JAX's checkpointed forward at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit import extract_state, functional_call
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.optimizer.functional import FunctionalAdamW as JaxAdamW
from paddle_tpu.trainer.pretrain import PretrainConfig as JaxPretrainConfig
from paddle_tpu.trainer.pretrain import (
    build_llama_pretrain_step as jax_build_step, make_hybrid_mesh_for)

from paddle_tpu_torch.convert import load_reference_state, pretrain_state_dict
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import flash_sdpa
from paddle_tpu_torch.optimizer import FunctionalAdamW
from paddle_tpu_torch.trainer import (PretrainConfig,
                                      build_llama_pretrain_step,
                                      flops_per_token)

B, S, STEPS = 2, 16, 3
TINY = dict(num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1, max_position_embeddings=64)


def _batches(V):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(0, V, (B, S)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, axis=1)))
    return out


# ------------------------------------------------------------ forward
@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jm = JaxLlama(jax_tiny_config(**TINY))
    state = {k: np.asarray(v) for k, v in extract_state(jm).items()}
    tm = LlamaForCausalLM(llama_tiny_config(**TINY), device="cpu")
    load_reference_state(tm, state)
    return jm, tm


class TestForward:
    @pytest.mark.parametrize("padded", [False, True])
    def test_logits_and_loss(self, models, padded):
        jm, tm = models
        ids, labels = _batches(jm.config.vocab_size)[0]
        mask = None
        if padded:      # right padding: every row still sees key 0
            mask = np.ones((B, S), bool)
            mask[1, 11:] = False
        route = "flash_segmented" if padded else "flash"
        before = tfa.route_counts[route]
        loss, logits = tm(torch.from_numpy(ids).long(),
                          labels=torch.from_numpy(labels).long(),
                          attn_mask=None if mask is None
                          else torch.from_numpy(mask))
        assert tfa.route_counts[route] == before + TINY["num_hidden_layers"]
        jl, jlog = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels),
                      attn_mask=None if mask is None
                      else paddle.to_tensor(mask))
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlog._data), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(loss.detach()), float(jl._data),
                                   atol=1e-5, rtol=1e-5)
        assert tm(torch.from_numpy(ids).long()).shape == (B, S, 512)


class TestModelKnobs:
    """Each LlamaConfig knob turned on, held to the JAX model with the
    same knob on (the models share their config objects, so a knob is
    set on both and restored after)."""

    @staticmethod
    def _inputs():
        ids, labels = _batches(512)[0]
        return ids, labels

    def test_dense_attention_matches_jax(self, models):
        jm, tm = models
        ids, labels = self._inputs()
        mask = np.ones((B, S), bool)
        mask[1, 11:] = False
        jm.config.use_flash_attention = tm.config.use_flash_attention = False
        try:
            before = (flash_sdpa.plain_calls, dict(tfa.route_counts))
            loss, logits = tm(torch.from_numpy(ids).long(),
                              labels=torch.from_numpy(labels).long(),
                              attn_mask=torch.from_numpy(mask))
            # the composite, called directly: no flash call, no route
            assert (flash_sdpa.plain_calls, tfa.route_counts) == before
            jl, jlog = jm(paddle.to_tensor(ids),
                          labels=paddle.to_tensor(labels),
                          attn_mask=paddle.to_tensor(mask))
        finally:
            jm.config.use_flash_attention = True
            tm.config.use_flash_attention = True
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlog._data), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(loss.detach()), float(jl._data),
                                   atol=1e-5, rtol=1e-5)

    def test_recompute_gradients_match_jax(self, models):
        jm, tm = models
        ids, labels = self._inputs()
        L = TINY["num_hidden_layers"]
        jm.config.recompute = tm.config.recompute = True
        try:
            jm.train()
            tm.train()

            def jax_loss(state):
                loss, _ = functional_call(jm, state, paddle.to_tensor(ids),
                                          labels=paddle.to_tensor(labels))
                return loss._data

            jl, want = jax.jit(jax.value_and_grad(jax_loss))(
                extract_state(jm))
            n0 = flash_sdpa.plain_calls
            loss, _ = tm(torch.from_numpy(ids).long(),
                         labels=torch.from_numpy(labels).long())
            loss.backward()
            # each layer's forward ran again in the backward
            assert flash_sdpa.plain_calls == n0 + 2 * L
            got = {k: p.grad.numpy().copy()
                   for k, p in tm.named_parameters()}
        finally:
            jm.config.recompute = tm.config.recompute = False
            tm.zero_grad(set_to_none=True)
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   atol=1e-5, rtol=1e-5)
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], np.asarray(w), atol=1e-5,
                                       err_msg=k)


# ------------------------------------------------------------ AdamW
class TestAdamW:
    @pytest.mark.parametrize("moments", ["float32", "bfloat16"])
    def test_update_matches_jax(self, moments):
        rng = np.random.RandomState(3)
        shapes = {"a": (16, 8), "b": (8,), "c": (4, 4, 3)}
        params = {k: rng.randn(*s).astype(np.float32)
                  for k, s in shapes.items()}
        mask = {"a": True, "b": False, "c": True}
        kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1,
                  clip_norm=1.0, decay_mask=mask)
        jtx = JaxAdamW(3e-3, moment_dtype=jnp.dtype(moments), **kw)
        ttx = FunctionalAdamW(3e-3, moment_dtype=moments, **kw)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        js, ts = jtx.init(jp), ttx.init(tp)
        for step in range(STEPS):
            grads = {k: (rng.randn(*s) * (3 - step)).astype(np.float32)
                     for k, s in shapes.items()}
            jp, js, jn = jtx.update({k: jnp.asarray(g)
                                     for k, g in grads.items()}, js, jp)
            tp, ts, tn = ttx.update({k: torch.from_numpy(g)
                                     for k, g in grads.items()}, ts, tp)
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert ts.count == int(js.count) == STEPS
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
            for tm_, jm_ in ((ts.moment1, js.moment1),
                             (ts.moment2, js.moment2)):
                assert str(tm_[k].dtype).endswith(moments)
                want = np.asarray(jm_[k]).astype(np.float32)
                tol = dict(atol=1e-6, rtol=1e-6) if moments == "float32" \
                    else dict(atol=1e-8, rtol=8e-3)
                np.testing.assert_allclose(tm_[k].float().numpy(), want,
                                           **tol)

    def test_bf16_moments_refuse_a_stalling_beta2(self):
        with pytest.raises(ValueError, match="stalls"):
            FunctionalAdamW(1e-3, moment_dtype="bfloat16")   # b2 = 0.999


# ------------------------------------------------------------ pretrain
def _jax_trajectory(param_dtype, seed=5):
    paddle.seed(seed)
    mc = jax_tiny_config(**TINY)
    cfg = JaxPretrainConfig(mc, global_batch=B, seq_len=S,
                            param_dtype=param_dtype)
    mesh = make_hybrid_mesh_for(cfg, devices=jax.devices()[:1])
    st, step, _ = jax_build_step(cfg, mesh)
    init = pretrain_state_dict(jax.tree.map(np.asarray, st.master))
    losses, norms = [], []
    for ids, labels in _batches(mc.vocab_size):
        st, m = step(st, jnp.asarray(ids), jnp.asarray(labels))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = pretrain_state_dict(jax.tree.map(np.asarray, st.master))
    return init, losses, norms, final


def _port_trajectory(init, param_dtype, remat="full", **kw):
    mc = llama_tiny_config(**TINY)
    model = LlamaForCausalLM(mc, device="cpu")
    load_reference_state(model, init)
    cfg = PretrainConfig(mc, global_batch=B, seq_len=S,
                         param_dtype=param_dtype, remat=remat, **kw)
    st, step, meta = build_llama_pretrain_step(cfg, device="cpu",
                                               model=model)
    assert meta["flops_per_token"] == flops_per_token(mc)
    losses, norms = [], []
    for ids, labels in _batches(mc.vocab_size):
        st, m = step(st, ids, labels)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    assert st.step == STEPS and st.opt_state.count == STEPS
    return losses, norms, {k: v.numpy() for k, v in st.master.items()}, st


def _assert_bf16_trajectory(seed):
    """bf16 compute against JAX: losses at 2e-3 and grad norms at 2e-2
    relative; Adam normalizes each element, so where a bf16 gradient is
    close to zero its step may take the other sign in the other
    framework, and only 99% of the master weights are held at 1e-4."""
    init, losses, norms, final = _jax_trajectory("bfloat16", seed)
    got_l, got_n, got_w, st = _port_trajectory(init, "bfloat16")
    np.testing.assert_allclose(got_l, losses, rtol=2e-3)
    np.testing.assert_allclose(got_n, norms, rtol=2e-2)
    diff = np.concatenate([np.abs(got_w[k] - w).ravel()
                           for k, w in final.items()])
    assert np.mean(diff <= 1e-4) >= 0.99
    return st


@pytest.fixture(scope="module")
def jax_f32():
    return _jax_trajectory("float32")


class TestPretrainStep:
    def test_f32_trajectory_matches_jax(self, jax_f32):
        init, losses, norms, final = jax_f32
        got_l, got_n, got_w, st = _port_trajectory(init, "float32")
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        np.testing.assert_allclose(got_n, norms, rtol=1e-5)
        assert set(got_w) == set(final)
        for k, w in final.items():
            np.testing.assert_allclose(got_w[k], w, atol=2e-5, err_msg=k)
        assert all(p.dtype == torch.float32 for p in st.params.values())

    def test_bf16_trajectory_matches_jax(self):
        st = _assert_bf16_trajectory(seed=5)
        # compute weights are the master weights rounded to bf16
        for k, p in st.params.items():
            assert p.dtype == torch.bfloat16
            assert torch.equal(p.detach(), st.master[k].to(torch.bfloat16))

    def test_bf16_trajectory_matches_jax_second_seed(self):
        _assert_bf16_trajectory(seed=7)

    def test_remat_and_microbatches_keep_the_losses(self, jax_f32):
        init = jax_f32[0]
        base = _port_trajectory(init, "float32", remat="none")
        for kw in (dict(remat="full"), dict(remat="dots"),
                   dict(remat="none", n_microbatches=2)):
            got = _port_trajectory(init, "float32", **kw)
            np.testing.assert_allclose(got[0], base[0], rtol=1e-6,
                                       err_msg=str(kw))
            np.testing.assert_allclose(got[1], base[1], rtol=1e-5,
                                       err_msg=str(kw))

    @pytest.mark.parametrize("kw", [dict(dp=2), dict(mp=2), dict(pp=2),
                                    dict(sharding=2), dict(sep=2),
                                    dict(pp=2, pp_schedule="1F1B")])
    def test_multi_device_layouts_raise(self, kw):
        cfg = PretrainConfig(llama_tiny_config(**TINY), global_batch=B,
                             seq_len=S, **kw)
        with pytest.raises(NotImplementedError, match="queue A item 8"):
            build_llama_pretrain_step(cfg, device="cpu")

    def test_config_checks(self):
        mc = llama_tiny_config(**TINY)
        with pytest.raises(ValueError):
            PretrainConfig(mc, remat="some")
        with pytest.raises(ValueError):
            PretrainConfig(mc, moment_dtype="fp8")
        with pytest.raises(ValueError):
            PretrainConfig(mc, pp_schedule="1F1B")
