"""Optimizers of the port (counterpart of paddle_tpu/optimizer): the
functional AdamW of the pretraining step (``functional``), the learning
rate schedules (``lr``), and the eager ``Optimizer`` base with ``Adam``
and ``AdamW``, the loop users write by hand and the JAX package's
``Trainer.training_step`` drives::

    loss, _ = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()

Paddle semantics, as the JAX package's: per-parameter accumulators,
``multi_precision`` f32 master weights and moments for bf16 / f16
parameters (written back in the parameter's dtype after each update),
a ``grad_clip`` object run before the update, an ``LRScheduler`` read by
``get_lr()`` once a step, and a step count per optimizer. ``AdamW``
runs the same ``adamw_kernel`` as the functional one. Where the JAX
package rebinds new arrays, the port updates parameters, master weights
and moments in place. A float ``weight_decay`` only: the regularizer
objects (``L1Decay`` / ``L2Decay``), ``ParamAttr`` learning-rate
multipliers and the other eager optimizers (SGD, Momentum, ...) are not
ported (ROADMAP.md queue A item 7b).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import lr
from .functional import (AdamWState, FunctionalAdamW, adamw_kernel,
                         clip_tree_by_global_norm, global_norm)
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "lr", "adamw_kernel",
           "global_norm", "clip_tree_by_global_norm", "AdamWState",
           "FunctionalAdamW"]

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    """Eager optimizer over a list of parameters (``parameters`` is
    required, as in Paddle's dygraph mode). State is keyed by the
    parameter's position in that list."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError(
                "parameters must be given (eager mode, ref parity)")
        self._param_groups = list(parameters)
        self._index = {id(p): i for i, p in enumerate(self._param_groups)}
        self._lr = learning_rate
        wd = 0.0 if weight_decay is None else weight_decay
        if not isinstance(wd, (int, float)):
            raise TypeError(
                f"weight_decay: a float (regularizer objects are not "
                f"ported), got {type(wd).__name__}")
        self._weight_decay = float(wd)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._master: Dict[int, torch.Tensor] = {}
        self._step_count = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # -- state of a parameter ----------------------------------------------
    def _keeps_master(self, p) -> bool:
        return self._multi_precision and p.dtype in _LOW

    def _acc(self, name: str, p) -> torch.Tensor:
        """Accumulator `name` of `p`, zeros at first use: f32 for a bf16
        / f16 parameter, else the parameter's dtype."""
        store = self._accumulators.setdefault(name, {})
        i = self._index[id(p)]
        if i not in store:
            dt = torch.float32 if p.dtype in _LOW else p.dtype
            store[i] = torch.zeros_like(p, dtype=dt,
                                        memory_format=torch.contiguous_format)
        return store[i]

    def _master_weight(self, p) -> torch.Tensor:
        """The tensor the update writes: the f32 master copy under
        multi_precision; an f32 copy of a low-precision parameter without
        it (written back, rounded, by `_write_param`); else the parameter
        itself."""
        if self._keeps_master(p):
            i = self._index[id(p)]
            if i not in self._master:
                self._master[i] = p.detach().float()
            return self._master[i]
        return p.detach().float() if p.dtype in _LOW else p.detach()

    @staticmethod
    def _write_param(p, w) -> None:
        if w.data_ptr() != p.data_ptr():
            p.detach().copy_(w)

    # -- step --------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        """Clip, count the step, read the learning rate, then update
        every parameter that requires a gradient and has one."""
        params_grads = [(p, p.grad) for p in self._param_groups
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        lr_v = self.get_lr()
        for p, g in params_grads:
            if g is not None:
                self._update_param(p, g, lr_v)

    def _update_param(self, p, grad, lr_v: float) -> None:
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._param_groups:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict --------------------------------------------------------
    def state_dict(self) -> dict:
        """{"accumulators": {name: {position: tensor}}, "master":
        {position: tensor}, "step": n} (+ "LR_Scheduler"), positions as
        strings, as the JAX package keys them."""
        out = {"accumulators": {
            name: {str(i): v for i, v in store.items()}
            for name, store in self._accumulators.items()},
            "step": self._step_count,
            "master": {str(i): v for i, v in self._master.items()}}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state: dict) -> None:
        def on_param(i, v):
            p = self._param_groups[int(i)]
            return torch.as_tensor(v).to(p.device).clone()

        self._step_count = state.get("step", 0)
        self._accumulators = {
            name: {int(i): on_param(i, v) for i, v in store.items()}
            for name, store in state.get("accumulators", {}).items()}
        self._master = {int(i): on_param(i, v)
                        for i, v in state.get("master", {}).items()}
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])


class Adam(Optimizer):
    """Adam with coupled (L2) weight decay: ``weight_decay * w`` is
    added to the gradient before the moments."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _update_param(self, p, grad, lr_v):
        w = self._master_weight(p)
        g = grad.to(w.dtype)
        if self._weight_decay:
            g = g + self._weight_decay * w
        m, v = self._acc("moment1", p), self._acc("moment2", p)
        t = self._step_count
        m.mul_(self._b1).add_(g * (1 - self._b1))
        v.mul_(self._b2).add_(g.square() * (1 - self._b2))
        mhat = m / (1 - self._b1 ** t)
        vhat = v / (1 - self._b2 ** t)
        if self._amsgrad:
            vmax = self._acc("moment2_max", p)
            vmax.copy_(torch.maximum(vmax, vhat))
            vhat = vmax
        w.sub_(lr_v * mhat / (torch.sqrt(vhat) + self._eps))
        self._write_param(p, w)


class AdamW(Adam):
    """Decoupled weight decay through the shared ``adamw_kernel``;
    `apply_decay_param_fun(name)` (on a parameter's ``name`` attribute,
    where it has one) picks the decayed parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad)
        self._apply_decay_fn = apply_decay_param_fun

    def _update_param(self, p, grad, lr_v):
        do_decay = True
        pname = getattr(p, "name", None)
        if self._apply_decay_fn is not None and pname:
            do_decay = bool(self._apply_decay_fn(pname))
        w = self._master_weight(p)
        vmax = self._acc("moment2_max", p) if self._amsgrad else None
        adamw_kernel(w, grad, self._acc("moment1", p),
                     self._acc("moment2", p), self._step_count, lr=lr_v,
                     b1=self._b1, b2=self._b2, eps=self._eps,
                     weight_decay=self._weight_decay, do_decay=do_decay,
                     vmax=vmax)
        self._write_param(p, w)
