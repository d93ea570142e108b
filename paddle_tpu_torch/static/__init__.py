"""``static.InputSpec`` (counterpart of paddle_tpu/static/__init__.py:40).

Only ``InputSpec`` is ported: the signature ``jit.save`` exports a
program at. The rest of the static API (``Program``, ``Executor``,
``data``, ...) is ROADMAP.md queue A item 10.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = ["InputSpec", "to_torch_dtype"]

_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "double": torch.float64,
    "float16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64,
    "int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}


def to_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A Paddle dtype name ("float32", "int64", ...) or a torch dtype as
    the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "")
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


class InputSpec:
    """The shape and dtype of one input of an exported program. A ``None``
    dimension is stored as -1 (a dynamic one, which ``jit.save`` refuses);
    the dtype is a Paddle dtype name or a torch dtype, kept as the torch
    dtype."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = to_torch_dtype(dtype)
        self.name = name

    def __repr__(self) -> str:
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name!r})")
