"""Mixed precision (counterpart of the functional side of
paddle_tpu/amp)."""

from __future__ import annotations

from typing import Any, Union

import torch

__all__ = ["decorate_tree"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def decorate_tree(tree: Any, dtype: Union[str, torch.dtype] = "bfloat16"):
    """Functional O2 decorate: every floating tensor of a tree of dicts,
    lists and tuples cast to the compute dtype (round to nearest even),
    other leaves as they are. Returns a new tree; the casts are
    differentiable, so gradients reach the f32 leaves."""
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    if isinstance(tree, dict):
        return {k: decorate_tree(v, dt) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(decorate_tree(v, dt) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dt)
    return tree
