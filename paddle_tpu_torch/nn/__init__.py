"""Paddle-layout layers (counterpart of paddle_tpu/nn): ``Linear``,
``Embedding``, ``LayerNorm`` and ``RMSNorm``, as ``torch.nn.Module``s
whose parameters keep Paddle's layout and names (a Linear weight is
``[in, out]`` and computes ``x @ weight``), so state dicts carry over
key for key;
``functional`` holds the training path's ``rms_norm``, ``layer_norm``,
``gelu``, ``swiglu``, ``relu``, ``linear``, ``dropout`` and
``scaled_dot_product_attention``, and
``functional.flash_attention`` Paddle's attention namespace; ``clip`` the eager optimizers' gradient clips
``ClipGradByGlobalNorm`` and ``clip_grad_norm_``."""

from . import clip, functional
from .clip import ClipGradByGlobalNorm, clip_grad_norm_
from .common import Embedding, Linear
from .norm import LayerNorm, RMSNorm

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "functional",
           "clip", "ClipGradByGlobalNorm", "clip_grad_norm_"]
