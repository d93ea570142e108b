"""Device resolution and card reporting (counterpart of paddle_tpu/device).

The port's rule: an entry point given ``device=None`` runs on ``"cuda"``
and raises when CUDA is absent. Running on the CPU is always an explicit
request (``device="cpu"``), never a quiet fallback.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional, Union

import torch

__all__ = ["resolve_device", "card_report"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given, with
    a bare ``cuda`` pinned to its index (so devices compare equal).
    Raises RuntimeError for a CUDA device when
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_report(index: int = 0) -> Dict[str, object]:
    """Name, count, power limit and software versions of the card.

    ``nvidia_smi`` is the raw ``name, power.limit`` line of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for card ``index``, so that every measurement can carry it."""
    resolve_device("cuda")
    smi: Optional[str] = None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if index < len(lines):
        smi = lines[index]
    return {
        "kind": torch.cuda.get_device_name(index),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "capability": ".".join(map(str, torch.cuda.get_device_capability(
            index))),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
