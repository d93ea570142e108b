"""Model families of the port (counterpart of paddle_tpu/models)."""

from .ernie import Ernie45MoEForCausalLM, ernie45_moe_config
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt2_small_config,
                  gpt3_6_7b_config, gpt_tiny_config)
from .llama import (LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM,
                    LlamaModel, apply_rope, llama3_8b_config,
                    llama_tiny_config, precompute_rope)
from .moe_llm import (MoEConfig, MoEDecoderLayer, MoEForCausalLM, MoEModel,
                      qwen2_moe_tiny_config)
from .qwen2 import (Qwen2Config, Qwen2ForCausalLM, Qwen2Model,
                    qwen2_tiny_config)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "llama3_8b_config", "llama_tiny_config",
           "precompute_rope", "apply_rope", "GPTConfig", "GPTModel",
           "GPTForCausalLM", "gpt2_small_config", "gpt3_6_7b_config",
           "gpt_tiny_config", "Qwen2Config", "Qwen2Model",
           "Qwen2ForCausalLM", "qwen2_tiny_config", "MoEConfig",
           "MoEDecoderLayer", "MoEModel", "MoEForCausalLM",
           "qwen2_moe_tiny_config", "ernie45_moe_config",
           "Ernie45MoEForCausalLM"]
