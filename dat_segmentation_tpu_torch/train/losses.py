"""Losses, in PyTorch.

Counterpart of ``dat_segmentation_tpu/train/losses.py``: pixel
cross-entropy with ignore index 255 as the mean over the pixels that are
not ignored (0 when every pixel is), the 0.4-weighted auxiliary loss, the
soft-target CE of mixup and label-smoothing CE. Logits come in NHWC (or
(N, C)) with the classes last and are taken in float32, as in the JAX
package. On the card ``F.cross_entropy`` with ``ignore_index`` is the
idiom; the JAX package's gather-free masked sum was a TPU workaround.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, *, ignore_index: int = 255
) -> torch.Tensor:
    """logits (..., C), labels (...) int: mean CE over non-ignored pixels."""
    flat = logits.float().reshape(-1, logits.shape[-1])
    lbl = labels.reshape(-1).long()
    nll = F.cross_entropy(flat, lbl, ignore_index=ignore_index, reduction="sum")
    return nll / (lbl != ignore_index).sum().clamp_min(1)


def segmentation_loss(
    logits: torch.Tensor,
    aux_logits: Optional[torch.Tensor],
    labels: torch.Tensor,
    *,
    aux_weight: float = 0.4,
    ignore_index: int = 255,
) -> torch.Tensor:
    """main CE + aux_weight * aux CE."""
    loss = cross_entropy_loss(logits, labels, ignore_index=ignore_index)
    if aux_logits is not None:
        loss = loss + aux_weight * cross_entropy_loss(aux_logits, labels, ignore_index=ignore_index)
    return loss


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: batch mean of -sum(t * log_softmax)."""
    return torch.sum(-targets * F.log_softmax(logits.float(), dim=-1), dim=-1).mean()


def label_smoothing_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, *, smoothing: float = 0.1
) -> torch.Tensor:
    """torch ``CrossEntropyLoss(label_smoothing=s)`` on (N, C) logits."""
    return F.cross_entropy(logits.float(), labels.long(), label_smoothing=smoothing)
