"""Model families of the port (counterpart of paddle_tpu/models)."""

from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,
                    LlamaModel, apply_rope, llama3_8b_config,
                    llama_tiny_config, precompute_rope)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "llama3_8b_config", "llama_tiny_config",
           "precompute_rope", "apply_rope"]
