"""Model families of the port (counterpart of paddle_tpu/models)."""

from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    llama3_8b_config, llama_tiny_config, precompute_rope)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "llama3_8b_config", "llama_tiny_config", "precompute_rope"]
