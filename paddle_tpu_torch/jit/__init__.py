"""``to_static``, ``save`` and ``load`` (counterpart of
paddle_tpu/jit/__init__.py:267-287 and :303-397).

``to_static(fn_or_layer)`` captures the program with TorchDynamo and runs
the captured graphs eagerly; with ``FLAGS_use_fusion_compiler`` set when
a program is captured (the flag is read at each capture and recapture, as
the JAX package reads it at each trace), the graphs first go through the
pattern-fusion pass ``jit.fusion``. ``not_to_static`` marks a function to
run as written, outside any capture.

``save(layer, prefix, input_spec)`` exports the eval-mode forward with
the weights baked in, ``load(prefix)`` gives it back as an inference-only
`TranslatedLayer`, and ``inference.Predictor`` serves it (through the
static-program fusion pass ``jit.fusion_cc`` under
FLAGS_use_fusion_compiler). The artifacts:

- ``prefix.pdparams``: the state dict (``torch.save``), under the JAX
  package's ``extract_state`` keys; Paddle's own pickle format is
  ROADMAP.md queue A item 7b;
- ``prefix.pt2``: the servable, ``torch.export`` of the forward under
  ``torch.no_grad()``, decomposed to core ATen (``run_decompositions()``,
  the counterpart of StableHLO) and saved by ``torch.export.save``, with
  the device it was exported on (an exported program bakes it in);
- ``prefix.graph.txt``: the program's readable code (the counterpart of
  ``.stablehlo.txt``).

``TracedLayer`` and dy2static's conversion of Python control flow are
ROADMAP.md queue A item 7b: Dynamo follows Python control flow itself,
specializing on the values it sees.
"""

from __future__ import annotations

import zipfile
from typing import List, Optional

import torch
from torch import nn

from ..flags import flag
from ..static import to_torch_dtype
from . import fusion
from .fusion_cc import export_program

__all__ = ["to_static", "not_to_static", "StaticFunction", "fusion",
           "save", "load", "TranslatedLayer", "artifact_device"]


class StaticFunction:
    """A captured callable: `fn` under TorchDynamo, the fusion pass
    applied to each graph captured while FLAGS_use_fusion_compiler is
    set."""

    def __init__(self, fn):
        self._run = fusion.capture(
            fn, lambda: flag("FLAGS_use_fusion_compiler"))

    def __call__(self, *args, **kwargs):
        return self._run(*args, **kwargs)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """@paddle.jit.to_static: a function becomes a `StaticFunction`; a
    layer's ``forward`` is replaced by one and the layer returned. The
    capture takes the shapes it is called with, so `input_spec`,
    `build_strategy`, `backend` and further options raise rather than
    go unread."""
    given = {k: v for k, v in dict(kwargs, input_spec=input_spec,
                                   build_strategy=build_strategy,
                                   backend=backend).items()
             if v is not None}
    if given:
        raise NotImplementedError(
            f"to_static: {sorted(given)} not supported; the program is "
            "captured at the shapes it is called with")

    def wrap(fn):
        if isinstance(fn, nn.Module):
            fn.forward = StaticFunction(fn.forward)
            return fn
        return StaticFunction(fn)
    if function is not None:
        return wrap(function)
    return wrap


def not_to_static(fn):
    """Run `fn` as written, never captured: a call of it inside a
    captured program runs eagerly between the graphs around it."""
    return torch.compiler.disable(fn)


# ---------------------------------------------------------------------------
# save / load (the inference artifact)
# ---------------------------------------------------------------------------

def _device_of(layer: nn.Module) -> torch.device:
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return torch.device("cpu")


def _example_inputs(input_spec, device) -> List[torch.Tensor]:
    """Zero tensors at each spec's shape and dtype on `device`: a
    ``static.InputSpec``, a tensor or a (shape, dtype) pair, concrete dims
    only, as in the JAX package (a dynamic -1 / None dim needs shape
    polymorphism)."""
    out = []
    for s in input_spec:
        shape, dtype = s if isinstance(s, (tuple, list)) else \
            (s.shape, s.dtype)
        shape = tuple(shape)
        if any(d is None or d < 0 for d in shape):
            raise ValueError(f"jit.save needs concrete dims in InputSpec, "
                             f"got {shape}")
        out.append(torch.zeros(shape, dtype=to_torch_dtype(dtype),
                               device=device))
    return out


def save(layer: nn.Module, path: str, input_spec=None, **config) -> None:
    """Write ``path.pdparams`` and, given `input_spec`, the exported
    program ``path.pt2`` and its code ``path.graph.txt`` (see the module
    docstring). The export runs the layer in eval mode on the device of
    its parameters; every submodule's mode is restored afterwards (a
    blanket ``train()`` would clobber a deliberately frozen one)."""
    torch.save(layer.state_dict(), path + ".pdparams")
    if not input_spec:
        return
    device = _device_of(layer)
    examples = _example_inputs(input_spec, device)
    modes = [(m, m.training) for m in layer.modules()]
    layer.eval()
    try:
        ep = export_program(layer, *examples)
        torch.export.save(ep, path + ".pt2",
                          extra_files={"device": device.type})
        with open(path + ".graph.txt", "w") as f:
            f.write(ep.graph_module.print_readable(print_output=False))
    finally:
        for m, was in modes:
            m.training = was


def artifact_device(path: str) -> Optional[str]:
    """The device type ("cuda" / "cpu") a ``.pt2`` artifact was exported
    on, read without loading its weights; None if it records none."""
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if name.endswith("/extra/device") or name == "extra/device":
                return z.read(name).decode()
    return None


class TranslatedLayer:
    """``paddle.jit.load``'s result: an inference-only callable over the
    exported program, on the device it was exported on."""

    def __init__(self, exported):
        weights = list(exported.state_dict.values())
        self._device = weights[0].device if weights else torch.device("cpu")
        self._module = exported.module()

    def __call__(self, *args):
        with torch.no_grad():
            return self._module(*(torch.as_tensor(a).to(self._device)
                                  for a in args))

    def eval(self):
        return self

    def train(self, mode: bool = True):
        raise RuntimeError("TranslatedLayer is inference-only (the exported "
                           "program has no training graph)")


def load(path: str, **config) -> TranslatedLayer:
    """Load a ``jit.save`` artifact as an inference-only callable."""
    # this package imports paddle_tpu_torch.ops (through jit.fusion), which
    # registers the paddle_tpu_torch::flash_fwd node the program holds
    return TranslatedLayer(torch.export.load(path + ".pt2"))
