"""Paddle-layout layers (counterpart of paddle_tpu/nn): ``Linear``,
``Embedding`` and ``RMSNorm``, as ``torch.nn.Module``s whose parameters
keep Paddle's layout and names (a Linear weight is ``[in, out]`` and
computes ``x @ weight``), so state dicts carry over key for key;
``functional`` holds the training path's ``rms_norm`` and ``swiglu``."""

from . import functional
from .common import Embedding, Linear
from .norm import RMSNorm

__all__ = ["Linear", "Embedding", "RMSNorm", "functional"]
