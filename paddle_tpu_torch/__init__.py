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
request, and through its alternating path (``ragged=False``: the paged
decode kernels); batch generation through ``generation.generate`` and
``generate_cached``; and single-device Llama pretraining through
``trainer.build_llama_pretrain_step`` (flash attention forward and
backward as kernels; ``device="cpu"`` runs the plain versions); the
incubate fused-op surface (``incubate.nn``) and ``jit.to_static`` with
its pattern-fusion pass (``jit.fusion``); and the static inference path,
``jit.save`` -> ``inference.Predictor``, with its static-program fusion
pass (``jit.fusion_cc``). ROADMAP.md lists the rest.
"""

from .device import card_report, resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "card_report", "__version__"]
