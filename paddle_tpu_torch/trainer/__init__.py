"""Training entry points of the port (counterpart of paddle_tpu/trainer):
the single-device Llama pretraining step."""

from .pretrain import (PretrainConfig, TrainState, build_llama_pretrain_step,
                       flops_per_token, flops_per_token_hw)

__all__ = ["PretrainConfig", "TrainState", "build_llama_pretrain_step",
           "flops_per_token", "flops_per_token_hw"]
