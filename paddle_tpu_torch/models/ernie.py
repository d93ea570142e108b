"""ERNIE 4.5 MoE preset (counterpart of the MoE part of
paddle_tpu/models/ernie.py): shared + fine-grained routed experts behind
a dense first layer, on the MoE decoder family. The ERNIE 3.0 encoders
of that module are not ported yet (ROADMAP.md queue A item 5d)."""

from __future__ import annotations

from .moe_llm import MoEConfig, MoEForCausalLM

__all__ = ["ernie45_moe_config", "Ernie45MoEForCausalLM"]


def ernie45_moe_config(**kw) -> MoEConfig:
    """ERNIE 4.5-style MoE decoder preset (tiny widths; pass the
    published ones as keywords)."""
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, num_experts=8, top_k=2,
                moe_intermediate_size=64, shared_expert_intermediate_size=64,
                first_k_dense_replace=1)
    base.update(kw)
    return MoEConfig(**base)


class Ernie45MoEForCausalLM(MoEForCausalLM):
    """The MoE causal LM under the family's own name."""
