"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference this port is held
against; the port never imports it, nor JAX. Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a
hand-written CUDA C++ kernel for ``sm_90a`` under ``ops/csrc/``, built at
first use (``ops/_build.py``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``): a ``None`` device resolves to ``"cuda"`` and raises
when CUDA is absent. On CPU tensors each kernel wrapper runs its plain
PyTorch version instead, which is what the CPU tests exercise.

Ported so far (ROADMAP.md): Llama-family serving through
``serving.ServingEngine``'s unified ragged step, on the fused chain by
default (the megafront / megadecode kernels) and on the split chain on
request.
"""

from .device import card_report, resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "card_report", "__version__"]
