"""Incubating layers (counterpart of paddle_tpu/incubate): the routed
Mixture-of-Experts FFN (``moe``) and the fused-op surface (``nn``)."""

from . import moe, nn

__all__ = ["moe", "nn"]
