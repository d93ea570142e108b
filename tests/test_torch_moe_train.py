"""The port's MoE training slice against the JAX package on the CPU.

- gmm's backward on CPU tensors (the same ``torch.autograd.Function`` as
  on the card, whose backward runs the plain versions: ``gmm_plain``
  against rhs transposed for dlhs, ``tgmm_plain`` for drhs) against
  ``jax.vjp`` through the JAX Pallas kernel ``pallas_gmm.gmm`` (interpret
  mode on the CPU, as tests/test_gmm_kernel.py runs it) at "highest"
  matmul precision, on tests/test_torch_moe.py's GMM_CASES (empty
  groups, one group holding every row, rows past the last group): f32
  within 1e-5, bf16 within 2e-2; the CPU route counts plain calls on
  all three counters; ``tgmm_plain`` alone: an empty group's slab is
  zero, rows past the last group add nothing;
- eager MoE training: the tiny Qwen2-MoE preset (hidden 128, experts of
  128) in the dropless and in the capacity forward, and the tiny ERNIE
  4.5 MoE preset (a dense first layer, dropless), 3 f32 steps of
  ``AdamW(weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0))`` in
  both packages from the same weights on seeded ids and labels: the
  loss and the aux loss each step within 1e-5 relative, every
  parameter's gradient after step 1 within 1e-4 relative (tensor
  norm), every parameter after step 3 within 1e-4 relative. The JAX
  gradients are ``jax.value_and_grad`` of the same forward in one
  compiled program (its eager ``loss.backward()`` is the same VJP run op
  by op, ~5x slower on this lane), at its default FLAGS_gmm_impl; its
  update is ``optimizer.AdamW.step()`` (with ``ClipGradByGlobalNorm``)
  traced once into a program as well. The trajectories are computed
  once per module;
- the host-side pieces: every ``optimizer.lr`` schedule over 20 steps,
  float for float; ``ClipGradByGlobalNorm`` (with a ``need_clip=False``
  parameter), ``clip_grad_norm_`` (2-norm and inf) and
  ``ClipGradForMOEByGlobalNorm`` on seeded gradients; eager ``AdamW``
  with ``multi_precision`` on bf16 parameters (f32 masters and moments,
  the bf16 parameters written back) over 3 steps; ``amp.decorate`` at
  O1 and O2; ``SwitchMoELayer``'s forward, aux loss and gradients.
"""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.incubate import moe as tmoe
from paddle_tpu_torch.models import (Ernie45MoEForCausalLM, MoEForCausalLM,
                                     ernie45_moe_config,
                                     qwen2_moe_tiny_config)
from paddle_tpu_torch.ops.gmm import gmm, gmm_dlhs, tgmm, tgmm_plain

from test_torch_moe import GMM_CASES


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.incubate import moe as jmoe
    from paddle_tpu.jit import (_StateSwap, bind_grads, bind_state,
                                extract_state)
    from paddle_tpu.models import ernie as jernie
    from paddle_tpu.models import moe_llm as jmoe_llm
    from paddle_tpu.nn import clip as jclip
    from paddle_tpu.ops import pallas_gmm
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, paddle=paddle, Tensor=Tensor, moe=jmoe,
        StateSwap=_StateSwap, bind_grads=bind_grads, bind_state=bind_state,
        extract_state=extract_state, ernie=jernie, moe_llm=jmoe_llm,
        clip=jclip, gmm=pallas_gmm.gmm)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def rel(got, want) -> float:
    """||got - want|| / ||want|| in f64 (0 when both are zero)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    d, n = np.linalg.norm(g - w), np.linalg.norm(w)
    return float(d / n) if n else float(d)


# --------------------------------------------------------- gmm's backward
class TestGmmBackward:
    @pytest.mark.parametrize("M,K,N,sizes,dtype", GMM_CASES)
    def test_matches_jax_pallas_vjp(self, jx, M, K, N, sizes, dtype):
        rng = np.random.RandomState(7)
        lhs = rng.randn(M, K).astype(np.float32)
        rhs = (0.1 * rng.randn(len(sizes), K, N)).astype(np.float32)
        dout = rng.randn(M, N).astype(np.float32)
        gs = np.asarray(sizes, np.int32)
        jdt = jx.jnp.float32 if dtype == torch.float32 else jx.jnp.bfloat16
        jl, jr, jd = (jx.jnp.asarray(a, jdt) for a in (lhs, rhs, dout))

        def vjp(a, b, d):
            return jx.jax.vjp(lambda x, w: jx.gmm(x, w, jx.jnp.asarray(gs)),
                              a, b)[1](d)

        with jx.jax.default_matmul_precision("highest"):
            want_l, want_r = (np.asarray(w, np.float32)
                              for w in jx.jax.jit(vjp)(jl, jr, jd))
        x = _t(lhs).to(dtype).requires_grad_()
        w = _t(rhs).to(dtype).requires_grad_()
        before = {f.__name__: (f.launches, f.plain_calls)
                  for f in (gmm, gmm_dlhs, tgmm)}
        gmm(x, w, _t(gs)).backward(_t(dout).to(dtype))
        for f in (gmm, gmm_dlhs, tgmm):
            n, p = before[f.__name__]
            assert (f.launches, f.plain_calls) == (n, p + 1), f.__name__
        assert x.grad.dtype == dtype and w.grad.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(x.grad.float().numpy(), want_l,
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(w.grad.float().numpy(), want_r,
                                   atol=tol, rtol=tol)
        tail = int(gs.sum())
        np.testing.assert_array_equal(x.grad[tail:].float().numpy(), 0.0)
        for g in np.flatnonzero(gs == 0):
            np.testing.assert_array_equal(w.grad[g].float().numpy(), 0.0)

    def test_tgmm_plain_empty_groups_and_tail(self):
        rng = np.random.RandomState(1)
        lhs = _t(rng.randn(50, 8).astype(np.float32))
        dout = _t(rng.randn(50, 16).astype(np.float32))
        gs = torch.tensor([0, 20, 0, 15, 0], dtype=torch.int32)
        got = tgmm_plain(lhs, dout, gs)
        assert tuple(got.shape) == (5, 8, 16)
        for g in (0, 2, 4):
            assert int(got[g].count_nonzero()) == 0
        torch.testing.assert_close(got[1], lhs[:20].T @ dout[:20])
        torch.testing.assert_close(got[3], lhs[20:35].T @ dout[20:35])
        # the 15 tail rows add nothing: changing them changes nothing
        lhs2, dout2 = lhs.clone(), dout.clone()
        lhs2[35:] = 1e3
        dout2[35:] = -1e3
        torch.testing.assert_close(tgmm_plain(lhs2, dout2, gs), got,
                                   rtol=0, atol=0)


# ---------------------------------------------------- eager MoE training
STEPS, LR = 3, 1e-3
TRAIN_KW = dict(hidden_size=128, moe_intermediate_size=128)
RUNS = ("qwen2_moe_dropless", "qwen2_moe_capacity", "ernie45")


def _builds(jx, name):
    if name == "ernie45":
        return (lambda: jx.ernie.Ernie45MoEForCausalLM(
                    jx.ernie.ernie45_moe_config(moe_dropless=True)),
                lambda: Ernie45MoEForCausalLM(
                    ernie45_moe_config(moe_dropless=True), device="cpu"))
    kw = dict(TRAIN_KW, moe_dropless=name.endswith("dropless"))
    return (lambda: jx.moe_llm.MoEForCausalLM(
                jx.moe_llm.qwen2_moe_tiny_config(**kw)),
            lambda: MoEForCausalLM(qwen2_moe_tiny_config(**kw),
                                   device="cpu"))


def _batch(vocab):
    rng = np.random.RandomState(11)
    ids = rng.randint(0, vocab, (2, 16)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _jax_run(jx, jm, ids, labels):
    """3 steps of the JAX model: value_and_grad of its forward and its
    ``optimizer.AdamW.step()``, each traced once into a compiled program
    (the JAX package's optimizers are jnp code that runs eagerly or
    traced; op by op, their first step compiles every op of every shape,
    ~5 s a model on this lane)."""
    def pure_loss(state, i, lab):
        with jx.StateSwap([jm]):
            jx.bind_state(jm, state)
            loss, _ = jm(jx.Tensor(i), labels=jx.Tensor(lab))
            return loss._data, jm.model.aux_loss()._data

    names = list(jx.extract_state(jm))
    sd = jm.state_dict()
    params = [sd[k] for k in names]
    opt = jx.paddle.optimizer.AdamW(
        learning_rate=LR, parameters=params, weight_decay=0.1,
        grad_clip=jx.paddle.nn.ClipGradByGlobalNorm(1.0))

    def pure_step(ws, gs, m1, m2, count):
        saved = [(p._data, p._grad) for p in params]
        try:
            for p, w, g in zip(params, ws, gs):
                p._data, p._grad = w, jx.Tensor(g)
            opt._accumulators = {
                "moment1": {id(p): m for p, m in zip(params, m1)},
                "moment2": {id(p): v for p, v in zip(params, m2)}}
            opt._step_count = count
            opt.step()
            acc = opt._accumulators
            return ([p._data for p in params],
                    [acc["moment1"][id(p)] for p in params],
                    [acc["moment2"][id(p)] for p in params])
        finally:
            for p, (d, g) in zip(params, saved):
                p._data, p._grad = d, g
            opt._accumulators = {}

    grad_of = jx.jax.jit(jx.jax.value_and_grad(pure_loss, has_aux=True))
    update = jx.jax.jit(pure_step)
    ws = [p._data for p in params]
    m1 = [jx.jnp.zeros_like(w) for w in ws]
    m2 = [jx.jnp.zeros_like(w) for w in ws]
    losses, auxes, grads1 = [], [], None
    with jx.jax.default_matmul_precision("highest"):
        for s in range(STEPS):
            (loss, aux), grads = grad_of(dict(zip(names, ws)), ids, labels)
            losses.append(float(loss))
            auxes.append(float(aux))
            if s == 0:
                grads1 = {k: np.asarray(v) for k, v in grads.items()}
            ws, m1, m2 = update(ws, [grads[k] for k in names], m1, m2,
                                jx.jnp.int32(s))
    params = {k: np.asarray(w) for k, w in zip(names, ws)}
    return dict(losses=losses, aux=auxes, grads1=grads1, params=params)


def _torch_run(tm, ids, labels):
    opt = topt.AdamW(learning_rate=LR, parameters=tm.parameters(),
                     weight_decay=0.1,
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    losses, auxes, grads1 = [], [], None
    for s in range(STEPS):
        loss, _ = tm(_t(ids), labels=_t(labels))
        loss.backward()
        losses.append(float(loss.detach()))
        auxes.append(float(tm.model.aux_loss().detach()))
        if s == 0:
            grads1 = {k: p.grad.detach().clone().numpy()
                      for k, p in tm.named_parameters()}
        opt.step()
        opt.clear_grad()
    params = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    return dict(losses=losses, aux=auxes, grads1=grads1, params=params)


@pytest.fixture(scope="module")
def trajectories(jx):
    """{run: (JAX trajectory, port trajectory, port gmm counts)}, both
    from the JAX model's seeded weights."""
    from paddle_tpu_torch import ops
    out = {}
    for name in RUNS:
        jbuild, tbuild = _builds(jx, name)
        jx.paddle.seed(0)
        jm = jbuild()
        state = {k: np.asarray(v) for k, v in jx.extract_state(jm).items()}
        tm = tbuild()
        load_reference_state(tm, state)
        ids, labels = _batch(tm.config.vocab_size)
        ops.reset_counts()
        tr = _torch_run(tm, ids, labels)
        counts = ops.launch_counts()
        out[name] = (_jax_run(jx, jm, ids, labels), tr, counts)
    return out


class TestEagerTrainingAgainstJax:
    @pytest.mark.parametrize("run", RUNS)
    def test_losses_and_aux_each_step(self, trajectories, run):
        j, t, _ = trajectories[run]
        for a, b in (("losses", "losses"), ("aux", "aux")):
            np.testing.assert_allclose(t[a], j[b], rtol=1e-5, atol=0)
        assert t["losses"][-1] < t["losses"][0]

    @pytest.mark.parametrize("run", RUNS)
    def test_every_gradient_after_step_one(self, trajectories, run):
        j, t, _ = trajectories[run]
        assert set(t["grads1"]) == set(j["grads1"])
        for k, g in t["grads1"].items():
            assert rel(g, j["grads1"][k]) <= 1e-4, (k, rel(g, j["grads1"][k]))

    @pytest.mark.parametrize("run", RUNS)
    def test_every_parameter_after_three_steps(self, trajectories, run):
        j, t, _ = trajectories[run]
        assert set(t["params"]) == set(j["params"])
        for k, p in t["params"].items():
            assert rel(p, j["params"][k]) <= 1e-4, (k, rel(p, j["params"][k]))

    @pytest.mark.parametrize("run", RUNS)
    def test_routes_of_the_cpu_run(self, trajectories, run):
        """The dropless runs go through gmm and its backward (plain
        versions on the CPU: 3 of each a routed layer a step); the
        capacity run through none of them."""
        _, _, counts = trajectories[run]
        routed = 2 if run.startswith("qwen2") else 1
        n = 3 * routed * STEPS if run != "qwen2_moe_capacity" else 0
        for name in ("gmm", "gmm_dlhs", "tgmm"):
            assert counts[name] == {"launches": 0, "plain_calls": n}, name


class TestRecompute:
    def test_recompute_reruns_the_forward_and_keeps_gradients(self):
        """config.recompute in training mode checkpoints each layer (the
        JAX MoEModel's decision): the same loss and gradients, and each
        routed layer's gmm calls run again in the backward."""
        from paddle_tpu_torch import ops
        cfg = ernie45_moe_config(moe_dropless=True)
        base = Ernie45MoEForCausalLM(cfg, device="cpu")
        ids, labels = _batch(cfg.vocab_size)
        grads, counts = [], []
        for recompute in (False, True):
            cfg.recompute = recompute
            model = Ernie45MoEForCausalLM(cfg, device="cpu")
            model.load_state_dict(base.state_dict())
            ops.reset_counts()
            loss, _ = model(_t(ids), labels=_t(labels))
            loss.backward()
            counts.append(ops.launch_counts()["gmm"]["plain_calls"])
            grads.append({k: p.grad for k, p in model.named_parameters()})
        assert counts == [3, 6]
        for k, g in grads[0].items():
            torch.testing.assert_close(grads[1][k], g, rtol=1e-6, atol=1e-7)


# --------------------------------------------------- the host-side pieces
class _Const:
    """A schedule on the base class alone: 0.5 ** epoch."""

    @staticmethod
    def make(base):
        class Half(base):
            def get_lr(self):
                return self.base_lr * 0.5 ** self.last_epoch
        return Half(learning_rate=0.8)


def _schedules(lr):
    return {
        "LRScheduler": lambda: _Const.make(lr.LRScheduler),
        "NoamDecay": lambda: lr.NoamDecay(64, 5, learning_rate=2.0),
        "PiecewiseDecay": lambda: lr.PiecewiseDecay([3, 9], [0.1, 0.05,
                                                             0.01]),
        "NaturalExpDecay": lambda: lr.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: lr.InverseTimeDecay(0.5, 0.2),
        "PolynomialDecay": lambda: lr.PolynomialDecay(0.5, 7, cycle=True),
        "LinearWarmup": lambda: lr.LinearWarmup(
            lr.CosineAnnealingDecay(0.3, 10), 5, 0.0, 0.3),
        "ExponentialDecay": lambda: lr.ExponentialDecay(0.5, 0.9),
        "MultiStepDecay": lambda: lr.MultiStepDecay(0.5, [4, 11, 15]),
        "StepDecay": lambda: lr.StepDecay(0.5, 6, gamma=0.3),
        "LambdaDecay": lambda: lr.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "ReduceOnPlateau": lambda: lr.ReduceOnPlateau(0.5, patience=2,
                                                      cooldown=1),
        "CosineAnnealingDecay": lambda: lr.CosineAnnealingDecay(0.5, 12,
                                                                eta_min=0.01),
        "CosineAnnealingWarmRestarts": lambda:
            lr.CosineAnnealingWarmRestarts(0.5, 4, T_mult=2),
        "OneCycleLR": lambda: lr.OneCycleLR(0.5, 18),
        "CyclicLR": lambda: lr.CyclicLR(0.01, 0.5, 3, 5,
                                        mode="triangular2"),
        "LinearLR": lambda: lr.LinearLR(0.5, 12),
    }


PLATEAU = [3.0, 2.0, 2.5, 2.5, 2.6, 1.0, 1.2, 1.3, 1.4, 1.5] * 2


class TestHostPieces:
    def test_every_lr_schedule_float_for_float(self, jx):
        from paddle_tpu.optimizer import lr as jlr
        assert sorted(topt.lr.__all__) == sorted(jlr.__all__)
        ours, theirs = _schedules(topt.lr), _schedules(jlr)
        assert set(ours) == set(topt.lr.__all__)
        for name in ours:
            a, b = ours[name](), theirs[name]()
            ra, rb = [a()], [b()]
            for e in range(20):
                if name == "ReduceOnPlateau":
                    a.step(torch.tensor(PLATEAU[e], dtype=torch.float64))
                    b.step(PLATEAU[e])
                else:
                    a.step()
                    b.step()
                ra.append(a())
                rb.append(b())
            assert ra == rb, name
            assert len(set(ra)) > 1, name
            state = a.state_dict()
            assert state == b.state_dict(), name

    def test_optimizer_reads_its_scheduler(self):
        sched = topt.lr.StepDecay(0.1, 2, gamma=0.5)
        w = torch.nn.Parameter(torch.ones(4))
        opt = topt.AdamW(learning_rate=sched, parameters=[w])
        lrs = []
        for _ in range(5):
            w.grad = torch.ones(4)
            opt.step()
            lrs.append(opt.get_lr())
            sched.step()
        assert lrs == [0.1, 0.1, 0.05, 0.05, 0.025]
        with pytest.raises(RuntimeError, match="LRScheduler"):
            opt.set_lr(0.3)
        assert opt.state_dict()["LR_Scheduler"]["last_epoch"] == 5

    @staticmethod
    def _grad_sets(jx):
        rng = np.random.RandomState(3)
        shapes = [(6, 5), (7,), (3, 4, 2), (9,)]
        ws = [rng.randn(*s).astype(np.float32) for s in shapes]
        gs = [3.0 * rng.randn(*s).astype(np.float32) for s in shapes]
        tp = [torch.nn.Parameter(_t(w.copy())) for w in ws]
        jp = [jx.Tensor(jx.jnp.asarray(w), stop_gradient=False) for w in ws]
        for p, q, g in zip(tp, jp, gs):
            p.grad = _t(g.copy())
            q._grad = jx.Tensor(jx.jnp.asarray(g))
        return tp, jp

    def test_clip_by_global_norm(self, jx):
        for need_clip in (True, False):
            tp, jp = self._grad_sets(jx)
            tp[1].need_clip = jp[1].need_clip = need_clip
            got = tnn.ClipGradByGlobalNorm(1.5)([(p, p.grad) for p in tp])
            want = jx.clip.ClipGradByGlobalNorm(1.5)(
                [(p, p._grad) for p in jp])
            for (p, g), (_, h) in zip(got, want):
                assert g is p.grad      # scaled in place
                np.testing.assert_allclose(g.numpy(), np.asarray(h._data),
                                           rtol=1e-6, atol=1e-7)
            if not need_clip:
                np.testing.assert_array_equal(got[1][1].numpy(),
                                              np.asarray(jp[1]._grad._data))

    @pytest.mark.parametrize("norm_type", [2.0, float("inf")])
    def test_clip_grad_norm_(self, jx, norm_type):
        tp, jp = self._grad_sets(jx)
        total = tnn.clip_grad_norm_(tp, 2.0, norm_type=norm_type)
        jtotal = jx.clip.clip_grad_norm_(jp, 2.0, norm_type=norm_type)
        np.testing.assert_allclose(float(total), float(jtotal._data),
                                   rtol=1e-6)
        for p, q in zip(tp, jp):
            np.testing.assert_allclose(p.grad.numpy(),
                                       np.asarray(q._grad._data),
                                       rtol=1e-6, atol=1e-7)

    def test_clip_for_moe(self, jx):
        tp, jp = self._grad_sets(jx)
        got = tmoe.ClipGradForMOEByGlobalNorm(1.0)([(p, p.grad) for p in tp])
        jx.moe.ClipGradForMOEByGlobalNorm(1.0)([(p, p._grad) for p in jp])
        for (p, g), q in zip(got, jp):
            assert g is p.grad
            np.testing.assert_allclose(g.numpy(), np.asarray(q._grad._data),
                                       rtol=1e-6, atol=1e-7)

    def test_multi_precision_adamw_on_bf16_params(self, jx):
        """amp.decorate O2 then 3 AdamW steps on the bf16 Linears of both
        packages: f32 masters and moments, bf16 parameters written back."""
        rng = np.random.RandomState(5)
        jx.paddle.seed(0)
        jl = jx.paddle.nn.Sequential(jx.paddle.nn.Linear(16, 8),
                                     jx.paddle.nn.Linear(8, 4))
        tl = torch.nn.Sequential(tnn.Linear(16, 8, device="cpu"),
                                 tnn.Linear(8, 4, device="cpu"))
        state = {k: np.asarray(v) for k, v in jx.extract_state(jl).items()}
        load_reference_state(tl, state)
        jopt = jx.paddle.optimizer.AdamW(
            learning_rate=1e-2, parameters=jl.parameters(), weight_decay=0.1,
            grad_clip=jx.paddle.nn.ClipGradByGlobalNorm(1.0))
        topt_ = topt.AdamW(learning_rate=1e-2, parameters=tl.parameters(),
                           weight_decay=0.1,
                           grad_clip=tnn.ClipGradByGlobalNorm(1.0))
        jl, jopt = jx.paddle.amp.decorate(jl, jopt, level="O2")
        tl, topt_ = tamp.decorate(tl, topt_, level="O2")
        assert topt_._multi_precision and jopt._multi_precision
        tparams = list(tl.parameters())
        jparams = list(jl.parameters())
        for p, q in zip(tparams, jparams):
            assert p.dtype == torch.bfloat16
            assert str(q._data.dtype) == "bfloat16"
        for _ in range(3):
            for p, q in zip(tparams, jparams):
                g = rng.randn(*p.shape).astype(np.float32)
                p.grad = _t(g).to(torch.bfloat16)
                q._grad = jx.Tensor(jx.jnp.asarray(g, jx.jnp.bfloat16))
            topt_.step()
            jopt.step()
        assert topt_._step_count == jopt._step_count == 3
        for i, (p, q) in enumerate(zip(tparams, jparams)):
            master = topt_._master[i]
            assert master.dtype == torch.float32
            np.testing.assert_allclose(master.numpy(),
                                       np.asarray(jopt._master[id(q)]),
                                       rtol=1e-5, atol=1e-6)
            for name in ("moment1", "moment2"):
                m = topt_._accumulators[name][i]
                assert m.dtype == torch.float32
                np.testing.assert_allclose(
                    m.numpy(), np.asarray(jopt._accumulators[name][id(q)]),
                    rtol=1e-5, atol=1e-7)
            # the written-back parameter is the master rounded to bf16
            torch.testing.assert_close(p.detach(), master.to(torch.bfloat16),
                                       rtol=0, atol=0)
            np.testing.assert_allclose(
                p.detach().float().numpy(),
                np.asarray(q._data.astype(jx.jnp.float32)),
                rtol=2 ** -8, atol=1e-6)
        sd = topt_.state_dict()
        assert sd["step"] == 3 and set(sd["master"]) == {"0", "1", "2", "3"}
        fresh = topt.AdamW(parameters=tl.parameters(), multi_precision=True)
        fresh.set_state_dict(sd)
        torch.testing.assert_close(fresh._master[2], topt_._master[2])

    @pytest.mark.parametrize("level", ["O1", "O2"])
    def test_decorate_levels(self, jx, level):
        jm = jx.paddle.nn.Linear(8, 4)
        tm = tnn.Linear(8, 4, device="cpu")
        jopt = jx.paddle.optimizer.AdamW(parameters=jm.parameters())
        opt = topt.AdamW(parameters=tm.parameters())
        w = tm.weight
        jm, jopt = jx.paddle.amp.decorate(jm, jopt, level=level)
        tm_, opt_ = tamp.decorate(tm, opt, level=level)
        assert tm_ is tm and opt_ is opt and tm.weight is w
        want = "bfloat16" if level == "O2" else "float32"
        assert str(jm.weight._data.dtype) == want
        assert str(tm.weight.dtype) == f"torch.{want}"
        assert opt._multi_precision == jopt._multi_precision is True
        opt2 = topt.AdamW(parameters=tm.parameters())
        tamp.decorate([tm], [opt2], level=level, master_weight=False)
        assert opt2._multi_precision is False
        with pytest.raises(ValueError, match="O1 or O2"):
            tamp.decorate(tm, level="O3")

    def test_switch_moe_layer_forward_and_gradients(self, jx):
        jx.paddle.seed(0)
        jl = jx.moe.SwitchMoELayer(32, 64, 4)
        tl = tmoe.SwitchMoELayer(32, 64, 4, device="cpu")
        assert tl.top_k == 1 and tl.activation == "gelu"
        state = {k: np.asarray(v) for k, v in jx.extract_state(jl).items()}
        load_reference_state(tl, state)
        rng = np.random.RandomState(9)
        x = rng.randn(2, 8, 32).astype(np.float32)
        r = rng.randn(2, 8, 32).astype(np.float32)

        def jloss(st, xa):
            with jx.StateSwap([jl]):
                jx.bind_state(jl, st)
                out = jl(jx.Tensor(xa))
                return ((out._data * r).sum() + jl.l_aux._data,
                        (out._data, jl.l_aux._data))

        with jx.jax.default_matmul_precision("highest"):
            (_, (jout, jaux)), (jg, jgx) = jx.jax.jit(jx.jax.value_and_grad(
                jloss, argnums=(0, 1), has_aux=True))(
                    jx.extract_state(jl), jx.jnp.asarray(x))
        tx = _t(x).requires_grad_()
        out = tl(tx)
        ((out * _t(r)).sum() + tl.l_aux).backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tl.l_aux.detach()), float(jaux),
                                   rtol=1e-6)
        assert rel(tx.grad.numpy(), jgx) <= 1e-5
        for k, p in tl.named_parameters():
            assert rel(p.grad.numpy(), jg[k]) <= 1e-5, k
        assert float(tl.gate_weight.grad.abs().sum()) > 0
