"""Single-device parts of paddle_tpu/distributed that the training path
needs: activation recompute and the cross-entropy of the vocab-parallel
head. Meshes, collectives and the pipeline are ROADMAP.md queue A item 8."""

from .parallel_layers import ParallelCrossEntropy
from .recompute import recompute

__all__ = ["recompute", "ParallelCrossEntropy"]
