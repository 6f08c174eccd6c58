"""Auxiliary losses.

Counterpart of `yolat_tpu/nn/losses.py` (`smooth_cross_entropy` :13-24;
the reference's utils/loss.py:5-24, shipped but unused by the canonical
path).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_cross_entropy(logits, labels, smoothing: float = 0.2, mask=None):
    """Label-smoothed cross entropy over [P, K] logits: the target puts
    1 - smoothing on the label and smoothing / (K - 1) on every other
    class; the mean over the rows, or over the rows of `mask`."""
    k = logits.shape[-1]
    on = 1.0 - smoothing
    off = smoothing / (k - 1)
    target = F.one_hot(labels.long(), k).to(logits.dtype) * (on - off) + off
    nll = -(target * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    if mask is not None:
        m = mask.to(nll.dtype)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
