"""The port's kernels: hand-written CUDA C++ for Hopper, each with a
plain PyTorch version beside it (see ``oracles.py``)."""

from __future__ import annotations

from typing import Dict

from .elementwise import (generic_elementwise,
                          generic_elementwise_reference)
from .flash import (flash_kernel_eligible, flash_sdpa, flash_sdpa_bwd,
                    flash_sdpa_bwd_reference, flash_sdpa_reference)
from .flashmask import (bands_from_startend, flashmask_block_kinds,
                        flashmask_kernel_eligible, flashmask_sdpa,
                        flashmask_sdpa_bwd, flashmask_sdpa_bwd_reference,
                        flashmask_sdpa_reference)
from .gmm import (gmm, gmm_dlhs, gmm_kernel_eligible, gmm_plain, tgmm,
                  tgmm_plain)
from .fused import (append_rows_reference,
                    bias_residual_layer_norm_reference, fused_append_rows,
                    fused_bias_residual_layer_norm, fused_layer_norm,
                    fused_moe_dispatch_combine, fused_rms_norm, fused_rope,
                    fused_rope_append, fused_rope_bwd, layer_norm_reference,
                    moe_dc_eligible, moe_dispatch_combine_reference,
                    rms_norm_reference, rope_append_reference,
                    rope_reference, swiglu, swiglu_reference)
from .megadecode import (fused_ffn, fused_oproj_norm, megadecode_eligible,
                         megadecode_ffn_reference, oproj_norm_reference)
from .megafront import (fused_qkv_rope_append, megafront_eligible,
                        qkv_rope_append_reference)
from .mla import (mla_decode_attention, mla_decode_reference,
                  mla_kernel_eligible)
from .oracles import oracles
from .paged import (default_pages_per_group, paged_decode_attention,
                    paged_decode_attention_v2, paged_decode_reference,
                    paged_decode_v2_reference, paged_kernel_eligible)
# the router `paged_attention` stays in its module: exported here, the
# function would shadow the submodule ``ops.paged_attention``
from .paged_attention import append_to_cache, paged_attention_reference
from .quant import (int4_dequantize, int4_dequantize_reference, int4_planes,
                    weight_dequantize, weight_only_linear,
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
           "flashmask_sdpa", "flashmask_sdpa_reference", "flashmask_sdpa_bwd",
           "flashmask_sdpa_bwd_reference", "flashmask_kernel_eligible",
           "flashmask_block_kinds", "bands_from_startend",
           "paged_decode_attention", "paged_decode_attention_v2",
           "paged_decode_reference", "paged_decode_v2_reference",
           "paged_kernel_eligible", "default_pages_per_group",
           "paged_attention_reference", "append_to_cache",
           "weight_quantize", "weight_dequantize", "int4_planes",
           "weight_only_linear", "weight_only_linear_reference", "gmm",
           "gmm_plain", "gmm_dlhs", "tgmm", "tgmm_plain",
           "gmm_kernel_eligible", "fused_append_rows",
           "append_rows_reference", "int4_dequantize",
           "int4_dequantize_reference", "mla_decode_attention",
           "mla_decode_reference", "mla_kernel_eligible", "swiglu",
           "swiglu_reference", "fused_rope", "fused_rope_bwd",
           "rope_reference", "fused_bias_residual_layer_norm",
           "bias_residual_layer_norm_reference",
           "fused_moe_dispatch_combine", "moe_dispatch_combine_reference",
           "moe_dc_eligible", "generic_elementwise",
           "generic_elementwise_reference", "oracles",
           "launch_counts", "reset_counts"]


def _counted():
    """(name, wrapper) of every counted wrapper: each registered kernel
    and each of its backward wrappers, under the wrapper's own name."""
    for name, e in oracles().items():
        yield name, e.kernel
        for fn in e.backward:
            yield fn.__name__, fn


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
