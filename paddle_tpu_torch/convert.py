"""Weight carry-over from the JAX package (counterpart of the
``paddle_tpu.jit.extract_state`` side).

``extract_state(model)`` on the JAX side yields ``{name: array}`` for
every parameter and persistable buffer; converted to numpy, that dict
loads into the port's model of the same configuration with
`load_reference_state`. The JAX pretraining step keeps its weights (and
its Adam moments) as ``{"stacked": {...}, "outer": {...}}`` trees;
`pretrain_state_dict` names them as the port's state dict. The port
never imports JAX: the caller (a test) does the ``np.asarray``
conversion.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_state", "pretrain_state_dict"]


def load_reference_state(model: nn.Module,
                         state: Dict[str, np.ndarray]) -> None:
    """Copy every array of ``state`` into the parameter or persistent
    buffer of the same name, cast to that tensor's dtype on its device.

    Names and shapes must match exactly: a missing or extra key raises
    KeyError and a shape mismatch ValueError, both before anything is
    written."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"extra {extra}")
    arrays = {}
    for name, value in state.items():
        arr = np.asarray(value)
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: state shape {tuple(arr.shape)} vs "
                             f"model shape {tuple(own[name].shape)}")
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)    # numpy has no native bf16
        arrays[name] = arr
    with torch.no_grad():
        for name, arr in arrays.items():
            own[name].copy_(torch.tensor(arr))


def pretrain_state_dict(tree: Dict[str, Dict[str, np.ndarray]],
                        ) -> Dict[str, np.ndarray]:
    """The JAX pretraining step's ``{"stacked", "outer"}`` tree (of its
    master weights, compute weights or one Adam moment) as
    ``{state-dict name: array}``. ``stacked[sub]`` is ``[stages,
    layers / stages, ...]`` (``[1, L, ...]`` on one device); entry
    ``[s, j]`` is layer ``s * (L / stages) + j``, named
    ``llama.layers.{i}.{sub}``. ``outer`` keeps its names."""
    out = {k: np.asarray(v) for k, v in tree["outer"].items()}
    for sub, arr in tree["stacked"].items():
        arr = np.asarray(arr)
        flat = arr.reshape((arr.shape[0] * arr.shape[1],) + arr.shape[2:])
        for i in range(flat.shape[0]):
            out[f"llama.layers.{i}.{sub}"] = flat[i]
    return out
