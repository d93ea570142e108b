"""The port's kernels: hand-written CUDA C++ for Hopper, each with a
plain PyTorch version beside it (see ``oracles.py``)."""

from __future__ import annotations

from typing import Dict

from .fused import (fused_rms_norm, fused_rope_append, rms_norm_reference,
                    rope_append_reference)
from .oracles import oracles
from .ragged import ragged_attention_reference, ragged_paged_attention

__all__ = ["fused_rms_norm", "rms_norm_reference", "fused_rope_append",
           "rope_append_reference", "ragged_paged_attention",
           "ragged_attention_reference", "oracles", "launch_counts",
           "reset_counts"]


def launch_counts() -> Dict[str, Dict[str, int]]:
    """{kernel name: {"launches": kernel launches, "plain_calls": plain
    version calls}} for every registered kernel."""
    return {name: {"launches": e.kernel.launches,
                   "plain_calls": e.kernel.plain_calls}
            for name, e in oracles().items()}


def reset_counts() -> None:
    """Set every kernel's launch and plain-call counts to 0."""
    for e in oracles().values():
        e.kernel.launches = 0
        e.kernel.plain_calls = 0
