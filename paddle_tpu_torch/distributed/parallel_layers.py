"""ParallelCrossEntropy on one device (counterpart of
paddle_tpu/distributed/parallel_layers.py:ParallelCrossEntropy; the
vocab-sharded form is ROADMAP.md queue A item 8)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["ParallelCrossEntropy"]


class ParallelCrossEntropy(nn.Module):
    """Token cross-entropy ``[..., 1]``: the f32 logsumexp of the logits
    minus the picked logit, 0 where the label is `ignore_index`."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        lg32 = logits.float()
        lse = torch.logsumexp(lg32, dim=-1)
        lab = label[..., 0] if label.dim() == logits.dim() else label
        lab = torch.as_tensor(lab, device=logits.device).long()
        keep = lab != self.ignore_index
        idx = lab.clamp(0, logits.shape[-1] - 1)  # ignored rows: any index
        picked = torch.gather(lg32, -1, idx[..., None])[..., 0]
        loss = torch.where(keep, lse - picked, torch.zeros_like(lse))
        return loss[..., None]
