"""Incubating layers (counterpart of paddle_tpu/incubate): the routed
Mixture-of-Experts FFN (``moe``)."""

from . import moe

__all__ = ["moe"]
