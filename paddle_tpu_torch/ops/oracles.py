"""Kernel registry of the port (counterpart of paddle_tpu/ops/oracles.py).

Every ported kernel registers, in its own module and under the same name
as in the JAX package's registry, the pair that certifies it: the kernel
wrapper (which launches the hand-written CUDA kernel on CUDA tensors)
and its plain PyTorch version with the same signature (which the wrapper
runs for CPU tensors, and which the CPU tests and ``chip_smoke.py`` hold
the kernel against). A kernel with a gradient of its own names its
backward wrappers as ``backward`` (each with its own ``.launches`` and
``.plain_calls``, counted under its own name). ``parity_test`` names the
pytest node that compares the plain version with the JAX kernel and
reference, ``backward_parity_test`` the one that holds the backward to
the JAX kernel's VJP where another node does.

The names registered here are the port's progress through the JAX
registry; ``tests/test_torch_port_rules.py`` reads both.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = ["OracleEntry", "register_oracle", "oracles"]


@dataclasses.dataclass(frozen=True)
class OracleEntry:
    name: str
    kernel: Callable
    reference: Callable
    parity_test: str                    # pytest node id (file::name)
    backward: Tuple[Callable, ...] = ()  # backward wrappers, if any
    backward_parity_test: Optional[str] = None


_REGISTRY: Dict[str, OracleEntry] = {}


def register_oracle(name: str, kernel: Callable, reference: Callable, *,
                    parity_test: str,
                    backward: Tuple[Callable, ...] = (),
                    backward_parity_test: Optional[str] = None
                    ) -> OracleEntry:
    entry = OracleEntry(name=name, kernel=kernel, reference=reference,
                        parity_test=parity_test, backward=tuple(backward),
                        backward_parity_test=backward_parity_test)
    _REGISTRY[name] = entry
    return entry


def oracles() -> Dict[str, OracleEntry]:
    """Every registered kernel. Importing ``paddle_tpu_torch.ops`` fills
    the registry."""
    return dict(_REGISTRY)
