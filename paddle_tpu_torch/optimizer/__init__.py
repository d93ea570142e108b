"""Optimizers of the port (counterpart of paddle_tpu/optimizer): the
functional AdamW of the pretraining step."""

from .functional import (AdamWState, FunctionalAdamW, adamw_kernel,
                         clip_tree_by_global_norm, global_norm)

__all__ = ["adamw_kernel", "global_norm", "clip_tree_by_global_norm",
           "AdamWState", "FunctionalAdamW"]
