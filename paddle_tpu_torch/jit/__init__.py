"""``to_static`` (counterpart of paddle_tpu/jit/__init__.py:267-287).

``to_static(fn_or_layer)`` captures the program with TorchDynamo and runs
the captured graphs eagerly; with ``FLAGS_use_fusion_compiler`` set when
a program is captured (the flag is read at each capture and recapture, as
the JAX package reads it at each trace), the graphs first go through the
pattern-fusion pass ``jit.fusion``. ``not_to_static`` marks a function to
run as written, outside any capture. ``save`` / ``load`` /
``TracedLayer`` and dy2static's conversion of Python control flow are
ROADMAP.md queue A item 7b: Dynamo follows Python control flow itself,
specializing on the values it sees.
"""

from __future__ import annotations

from torch import nn

from ..flags import flag
from . import fusion

__all__ = ["to_static", "not_to_static", "StaticFunction", "fusion"]


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
    import torch
    return torch.compiler.disable(fn)
