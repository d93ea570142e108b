"""The port's kernels: hand-written CUDA C++ for Hopper, each with a
plain PyTorch version beside it (see ``oracles.py``)."""

from __future__ import annotations

from typing import Dict

from .flash import (flash_kernel_eligible, flash_sdpa, flash_sdpa_bwd,
                    flash_sdpa_bwd_reference, flash_sdpa_reference)
from .gmm import gmm, gmm_kernel_eligible, gmm_plain
from .fused import (fused_layer_norm, fused_rms_norm, fused_rope_append,
                    layer_norm_reference, rms_norm_reference,
                    rope_append_reference)
from .megadecode import (fused_ffn, fused_oproj_norm, megadecode_eligible,
                         megadecode_ffn_reference, oproj_norm_reference)
from .megafront import (fused_qkv_rope_append, megafront_eligible,
                        qkv_rope_append_reference)
from .oracles import oracles
from .paged import (default_pages_per_group, paged_decode_attention,
                    paged_decode_attention_v2, paged_decode_reference,
                    paged_decode_v2_reference, paged_kernel_eligible)
# the router `paged_attention` stays in its module: exported here, the
# function would shadow the submodule ``ops.paged_attention``
from .paged_attention import append_to_cache, paged_attention_reference
from .quant import (int4_planes, weight_dequantize, weight_only_linear,
                    weight_only_linear_reference, weight_quantize)
from .ragged import ragged_attention_reference, ragged_paged_attention

__all__ = ["fused_rms_norm", "rms_norm_reference", "fused_layer_norm",
           "layer_norm_reference", "fused_rope_append",
           "rope_append_reference", "ragged_paged_attention",
           "ragged_attention_reference", "fused_qkv_rope_append",
           "qkv_rope_append_reference", "megafront_eligible",
           "fused_oproj_norm", "oproj_norm_reference", "fused_ffn",
           "megadecode_ffn_reference", "megadecode_eligible",
           "flash_sdpa", "flash_sdpa_reference", "flash_sdpa_bwd",
           "flash_sdpa_bwd_reference", "flash_kernel_eligible",
           "paged_decode_attention", "paged_decode_attention_v2",
           "paged_decode_reference", "paged_decode_v2_reference",
           "paged_kernel_eligible", "default_pages_per_group",
           "paged_attention_reference", "append_to_cache",
           "weight_quantize", "weight_dequantize", "int4_planes",
           "weight_only_linear", "weight_only_linear_reference", "gmm",
           "gmm_plain", "gmm_kernel_eligible", "oracles",
           "launch_counts", "reset_counts"]


def _counted():
    """(name, wrapper) of every counted wrapper: each registered kernel,
    and ``<name>_bwd`` for a kernel's backward wrapper."""
    for name, e in oracles().items():
        yield name, e.kernel
        if e.backward is not None:
            yield name + "_bwd", e.backward


def launch_counts() -> Dict[str, Dict[str, int]]:
    """{kernel name: {"launches": kernel launches, "plain_calls": plain
    version calls}} for every registered kernel and backward wrapper."""
    return {name: {"launches": fn.launches, "plain_calls": fn.plain_calls}
            for name, fn in _counted()}


def reset_counts() -> None:
    """Set every kernel's launch and plain-call counts to 0."""
    for _, fn in _counted():
        fn.launches = 0
        fn.plain_calls = 0
