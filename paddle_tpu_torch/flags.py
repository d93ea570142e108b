"""Runtime flag registry with environment override (counterpart of
paddle_tpu/flags.py).

The mechanism of the JAX package, with its three properties:

1. every flag is overridable by env ``FLAGS_<name>`` at import time,
2. flags are get/set-able at runtime (`set_flags` / `get_flags`, and
   `flags_guard` for a scoped override),
3. unknown flags raise instead of silently no-op.

Values are validated both when set and when read from the environment:
a refused value raises, it never degrades to another route. Only the
flags the port reads are defined:

- ``FLAGS_paged_impl``: the paged decode-attention route of
  ``ops.paged_attention.paged_attention``: "intree" (the v2 kernel, the
  default), "intree_v1" (the per-page v1 kernel) or "reference" (the
  plain gather composite). The JAX package's "bundled" names
  jax.experimental's TPU kernel, which has no counterpart here: it is
  refused with a message that says so.
- ``FLAGS_gmm_impl``: kept under the JAX package's name for the MoE
  experts' grouped GEMM. The port has one route, ``ops.gmm.gmm`` (the
  hand-written kernel on CUDA tensors, its plain version on CPU
  tensors), which "auto" (the default) and "intree" both name. The JAX
  package's "einsum" (a one-hot composite; ``ops.gmm.gmm_plain`` is the
  port's reference), "xla" (XLA's ``ragged_dot``) and "bundled"
  (jax.experimental's megablox kernel) have no counterpart here and are
  refused.
- ``FLAGS_mla_decode_impl``: the decode attention of the MLA family's
  ``generate_cached`` (``generation._mla_cached_step_body``, read when
  the body is built): "auto" (the default: the ``mla_decode_attention``
  kernel where ``ops.mla.mla_kernel_eligible`` takes the shape, else the
  two-einsum composite on CPU tensors and an error on the card), "fused"
  (the kernel) or "xla" (the two-einsum composite,
  ``generation.mla_decode_composite``, counted), the JAX package's
  names.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

__all__ = ["define_flag", "get_flags", "set_flags", "flag", "flags_guard"]

_lock = threading.RLock()


class _Flag:
    __slots__ = ("name", "default", "value", "type", "help", "validator")

    def __init__(self, name: str, default: Any, help: str = "",
                 validator: Optional[Callable[[Any], bool]] = None):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help
        self.validator = validator
        self.value = default
        raw = os.environ.get(name)
        if raw is not None:
            self.set(_parse(raw, self.type))

    def set(self, value: Any) -> None:
        if self.type is bool and isinstance(value, str):
            value = _parse(value, bool)
        elif not isinstance(value, self.type):
            try:
                value = self.type(value)
            except (TypeError, ValueError):
                raise TypeError(
                    f"flag {self.name} expects {self.type.__name__}, got "
                    f"{type(value).__name__}: {value!r}")
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"invalid value for flag {self.name}: {value!r}")
        self.value = value


def _parse(raw: str, ty: type) -> Any:
    if ty is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    return raw


_registry: Dict[str, _Flag] = {}


def define_flag(name: str, default: Any, help: str = "",
                validator: Optional[Callable[[Any], bool]] = None) -> None:
    """Register a flag. ``name`` must start with ``FLAGS_``. The
    validator returns False (or raises its own ValueError) to refuse a
    value."""
    if not name.startswith("FLAGS_"):
        raise ValueError(f"flag name must start with FLAGS_: {name}")
    with _lock:
        if name in _registry:
            raise ValueError(f"flag already defined: {name}")
        _registry[name] = _Flag(name, default, help, validator)


def flag(name: str) -> Any:
    """Fast read of a single flag value."""
    try:
        return _registry[name].value
    except KeyError:
        raise KeyError(f"unknown flag: {name}") from None


def get_flags(names: Optional[Iterable[str] | str] = None) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    with _lock:
        if names is None:
            names = list(_registry)
        out = {}
        for n in names:
            if n not in _registry:
                raise KeyError(f"unknown flag: {n}")
            out[n] = _registry[n].value
        return out


def set_flags(flags: Mapping[str, Any]) -> None:
    with _lock:
        for n, v in flags.items():
            if n not in _registry:
                raise KeyError(f"unknown flag: {n}")
            _registry[n].set(v)


class flags_guard:
    """Context manager that temporarily overrides flags."""

    def __init__(self, **overrides: Any):
        self._overrides = {k if k.startswith("FLAGS_") else "FLAGS_" + k: v
                           for k, v in overrides.items()}
        self._saved: Dict[str, Any] = {}

    def __enter__(self):
        self._saved = get_flags(list(self._overrides))
        set_flags(self._overrides)
        return self

    def __exit__(self, *exc):
        set_flags(self._saved)
        return False


#: the routes of ops.paged_attention.paged_attention
PAGED_IMPLS = ("intree", "intree_v1", "reference")


def _paged_impl_ok(value: str) -> bool:
    if value == "bundled":
        raise ValueError(
            "FLAGS_paged_impl='bundled' names jax.experimental's TPU "
            "paged-attention kernel, which has no counterpart in the "
            f"PyTorch port; choose one of {PAGED_IMPLS}")
    return value in PAGED_IMPLS


define_flag("FLAGS_paged_impl", "intree",
            "paged-attention decode kernel: 'intree' (the v2 kernel, pages "
            "staged in groups, ops/paged.py), 'intree_v1' (the per-page v1 "
            "kernel, kept for comparison) or 'reference' (the plain gather "
            "composite)",
            validator=_paged_impl_ok)


#: the names of the port's one grouped-GEMM route, ops.gmm.gmm
GMM_IMPLS = ("auto", "intree")
_GMM_ABSENT = {"einsum": "the one-hot composite (ops.gmm.gmm_plain is the "
                         "port's reference)",
               "xla": "XLA's ragged_dot",
               "bundled": "jax.experimental's megablox TPU kernel"}


def _gmm_impl_ok(value: str) -> bool:
    if value in _GMM_ABSENT:
        raise ValueError(
            f"FLAGS_gmm_impl={value!r} names {_GMM_ABSENT[value]}, which "
            f"has no counterpart in the PyTorch port; choose one of "
            f"{GMM_IMPLS}")
    return value in GMM_IMPLS


define_flag("FLAGS_gmm_impl", "auto",
            "grouped GEMM of the MoE experts: 'auto' and 'intree' both name "
            "the gmm kernel (ops/gmm.py), the port's one route",
            validator=_gmm_impl_ok)


define_flag("FLAGS_mla_decode_impl", "auto",
            "MLA absorbed-latent decode attention of generate_cached: "
            "'auto' (the single-cache-read kernel ops/mla.py where "
            "mla_kernel_eligible takes the shape, else the einsum pair on "
            "CPU tensors and an error on the card), "
            "'fused' (the kernel) or 'xla' (the two-einsum composite)",
            validator=lambda v: v in ("auto", "fused", "xla"))


define_flag("FLAGS_use_fusion_compiler", False,
            "run jit.to_static programs through the pattern-fusion pass "
            "(jit/fusion.py: sdpa, rmsnorm, swiglu, bias_residual_ln, "
            "moe_dispatch rewritten to the hand-written kernels); read at "
            "each capture")
