"""Mixed precision (counterpart of paddle_tpu/amp): ``decorate``, the
eager O1 / O2 setup of a model and its optimizers, and ``decorate_tree``,
its functional form for the pretraining step. ``auto_cast`` (the O1 op
lists) is not ported (ROADMAP.md queue A item 7b)."""

from __future__ import annotations

from typing import Any, Union

import torch

__all__ = ["decorate", "decorate_tree"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def decorate(models, optimizers=None, level: str = "O2",
             dtype: Union[str, torch.dtype] = "bfloat16", master_weight=None,
             save_dtype=None):
    """paddle.amp.decorate: at level "O2" every floating parameter of the
    model(s) is cast to `dtype` in place (the same ``Parameter`` objects,
    so optimizers built before keep them); "O1" casts nothing. Unless
    `master_weight` is False, each optimizer is set to keep f32 master
    weights and moments (``_multi_precision``). Returns the model(s), and
    the optimizer(s) when given, in the shapes they were passed. Buffers
    keep their dtype (the JAX package casts them too; the port's only
    floating buffers, the f32 rope tables, are cast to the activations'
    dtype where they are read, so the result is the same)."""
    if level not in ("O1", "O2"):
        raise ValueError(f"amp level must be O1 or O2, got {level!r}")
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
    out_models = model_list[0] if single else model_list
    if optimizers is None:
        return out_models
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        if master_weight is not False:
            o._multi_precision = True
    return out_models, (opt_list[0] if opt_single else opt_list)


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
