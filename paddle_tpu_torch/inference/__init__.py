"""Inference engine: paddle_infer's Config / Predictor / Tensor-handle API
(counterpart of paddle_tpu/inference/__init__.py).

The artifact is what ``jit.save(layer, prefix, input_spec)`` writes (see
``jit``): ``prefix.pt2``, the forward exported by ``torch.export`` with
the weights baked in. A `Predictor` loads it and runs its module; with
``FLAGS_use_fusion_compiler`` set when the Predictor is built, the
program first goes through the static-program fusion pass
``jit.fusion_cc`` (the CINN ApplyCinnPass analog), which rewrites its
norm, swiglu, attention and elementwise regions into the hand-written
kernels.

Where the port differs from the JAX package, on purpose:

- the device defaults to the card (``Config.enable_use_gpu``);
  ``Config.disable_gpu()`` selects the CPU, and a Predictor for the card
  raises when CUDA is absent;
- a Config whose device differs from the artifact's raises: an exported
  program bakes in the device it was exported on;
- with the flag set, a failure of the pass raises (the JAX package warns
  and runs the plain program; here that would hide the kernel);
- the serving metrics of the JAX module (queue wait, run seconds, batch
  size, run count) wait for ROADMAP.md queue A item 9.

``copy_to_cpu`` returns a numpy array; a bf16 output comes back as f32
(numpy has no bfloat16), exactly.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import jit as _jit
from .. import resilience as _res
from ..device import resolve_device
from ..flags import flag
from ..jit import fusion_cc

__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor"]


class Config:
    """paddle_infer.Config: the artifact prefix written by ``jit.save``,
    the device, the run deadline and the admission gate. TensorRT and IR
    switches are recorded and do nothing (the fusion pass is
    FLAGS_use_fusion_compiler)."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_prefix = prog_file
        self._device = "gpu"
        self._device_id = 0
        self._enable_memory_optim = True
        self._switches: Dict[str, bool] = {}
        self._deadline_s: Optional[float] = None
        self._admission: Optional[tuple] = None

    def set_deadline(self, seconds: Optional[float]):
        """Per-request wall-clock budget for Predictor.run: an expired
        budget yields a typed resilience.TimeoutResult (never a hang)."""
        self._deadline_s = float(seconds) if seconds else None

    def set_admission(self, max_inflight: int, queue_timeout_s: float = 0.0):
        """Queue-admission backpressure: at most max_inflight run() calls
        execute at once (shared across clone()s); a request that cannot
        get a slot within queue_timeout_s raises resilience.Overloaded."""
        self._admission = (int(max_inflight), float(queue_timeout_s))

    def set_prog_file(self, path: str):
        self._model_prefix = path

    def prog_file(self) -> Optional[str]:
        return self._model_prefix

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = "gpu"
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device == "gpu"

    def _torch_device(self) -> str:
        """The torch device the Predictor runs on."""
        return f"cuda:{self._device_id}" if self.use_gpu() else "cpu"

    def enable_memory_optim(self):
        self._enable_memory_optim = True

    def switch_ir_optim(self, flag: bool = True):
        self._switches["ir_optim"] = flag

    def enable_tensorrt_engine(self, *a, **k):
        # TensorRT is a library of finished kernels: not part of the port
        self._switches["tensorrt"] = False

    def summary(self) -> str:
        return (f"Config(model={self._model_prefix!r}, "
                f"device={self._torch_device()}, "
                f"switches={self._switches})")


class PredictorTensor:
    """paddle_infer.Tensor: copy_from_cpu / copy_to_cpu / shape /
    reshape. The value lives on the Predictor's device."""

    def __init__(self, name: str, shape: Sequence[int], dtype: torch.dtype,
                 device: torch.device):
        self.name = name
        self._shape = tuple(shape)
        self._dtype = dtype
        self._device = device
        self._value: Optional[torch.Tensor] = None

    def reshape(self, shape: Sequence[int]):
        self._shape = tuple(shape)

    def shape(self) -> List[int]:
        return list(self._value.shape if self._value is not None
                    else self._shape)

    def copy_from_cpu(self, data):
        t = torch.as_tensor(np.asarray(data))
        self._value = t.to(device=self._device, dtype=self._dtype)

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise RuntimeError(f"output {self.name!r} not computed yet — "
                               f"call predictor.run() first")
        v = self._value.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()

    def numpy(self) -> np.ndarray:
        return self.copy_to_cpu()


class Predictor:
    """paddle_infer.Predictor over a ``jit.save`` artifact (see the
    module docstring)."""

    def __init__(self, config: Config):
        self._config = config
        self._gate = _res.AdmissionGate(*config._admission) \
            if config._admission else None
        prefix = config.prog_file()
        if prefix is None:
            raise ValueError("Config needs the jit.save artifact prefix")
        path = prefix + ".pt2"
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found — export with paddle_tpu_torch.jit.save("
                f"layer, {prefix!r}, input_spec=[...])")
        self._device = resolve_device(config._torch_device())
        saved = _jit.artifact_device(path)
        if saved != self._device.type:
            raise ValueError(
                f"{path} was exported on {saved}, the Config asks for "
                f"{self._device.type}: an exported program runs on the "
                f"device it was exported on (Config.disable_gpu() selects "
                f"the CPU)")
        self._exported = torch.export.load(path)
        in_vals, out_vals = _user_values(self._exported)
        self._input_names = [f"x{i}" for i in range(len(in_vals))]
        self._output_names = [f"out{i}" for i in range(len(out_vals))]
        self._in_specs = [(tuple(v.shape), v.dtype) for v in in_vals]
        self._out_specs = [(tuple(v.shape), v.dtype) for v in out_vals]
        self._new_handles()
        self._call = self._exported.module()
        # FLAGS_use_fusion_compiler, read once here as in the JAX package:
        # the program goes through the static-program fusion pass; its
        # failure raises (no silent plain path)
        self.fused = None
        if flag("FLAGS_use_fusion_compiler"):
            self.fused = fusion_cc.fuse_compile(self._exported)
            self._call = self.fused

    def _new_handles(self):
        self._inputs = {n: PredictorTensor(n, s, d, self._device)
                        for n, (s, d) in zip(self._input_names,
                                             self._in_specs)}
        self._outputs = {n: PredictorTensor(n, s, d, self._device)
                         for n, (s, d) in zip(self._output_names,
                                              self._out_specs)}

    # --- paddle_infer API surface ---
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> PredictorTensor:
        return self._inputs[name]

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_output_handle(self, name: str) -> PredictorTensor:
        return self._outputs[name]

    def run(self, inputs: Optional[Sequence] = None,
            deadline_s: Optional[float] = None):
        """Execute. Either feed via get_input_handle().copy_from_cpu()
        then run(), or pass arrays positionally (then the outputs come
        back as numpy arrays).

        With a deadline (per-call ``deadline_s`` or Config.set_deadline)
        an over-budget request returns a falsy resilience.TimeoutResult
        instead of hanging (the program's dispatch is atomic, so the
        budget is enforced before and after it); with
        Config.set_admission, a request that cannot get a slot raises
        resilience.Overloaded."""
        budget = deadline_s if deadline_s is not None \
            else self._config._deadline_s
        dl = _res.Deadline(budget) if budget else None
        if self._gate is None:
            return self._run_inner(inputs, dl)
        with self._gate.admit():
            return self._run_inner(inputs, dl)

    def _run_inner(self, inputs, dl):
        if dl is not None and dl.expired():
            # spent the whole budget queueing: no dispatch at all
            _res.deadline_miss()
            return _res.TimeoutResult(kind="predictor",
                                      budget_s=dl.budget_s,
                                      elapsed_s=dl.elapsed_s)
        if inputs is not None:
            if len(inputs) != len(self._input_names):
                raise ValueError(
                    f"run() got {len(inputs)} inputs; the exported program "
                    f"takes {len(self._input_names)}")
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(a)
        args = []
        for n in self._input_names:
            v = self._inputs[n]._value
            if v is None:
                raise RuntimeError(f"input {n!r} not set")
            args.append(v)
        with torch.no_grad():
            outs = self._call(*args)
        flat = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        for n, o in zip(self._output_names, flat):
            self._outputs[n]._value = o
        result = [self._outputs[n].copy_to_cpu()
                  for n in self._output_names] if inputs is not None \
            else None
        if dl is not None and dl.expired():
            # the dispatch finished but blew the budget: a typed miss with
            # the full outputs attached (the handles hold them either way)
            _res.deadline_miss()
            return _res.TimeoutResult(kind="predictor",
                                      budget_s=dl.budget_s,
                                      elapsed_s=dl.elapsed_s,
                                      completed=len(flat), partial=result)
        return result

    def clone(self) -> "Predictor":
        """An independent predictor over the same program (the
        paddle_infer pattern for per-thread serving): shares the loaded
        program, the fusion pass's rewrite AND the admission gate
        (concurrency is a process-wide budget), gets fresh input and
        output handles."""
        new = object.__new__(Predictor)
        new.__dict__ = dict(self.__dict__)
        new._new_handles()
        return new


def _user_values(ep):
    """The example values of the exported program's user inputs and user
    outputs, in order."""
    from torch.export.graph_signature import InputKind, OutputKind
    sig = ep.graph_signature
    vals = {n.name: n.meta.get("val") for n in ep.graph.nodes
            if n.op == "placeholder"}
    ins = [vals[s.arg.name] for s in sig.input_specs
           if s.kind == InputKind.USER_INPUT]
    out = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [a.meta.get("val") for a, s in zip(out.args[0], sig.output_specs)
            if s.kind == OutputKind.USER_OUTPUT]
    return ins, outs


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
