"""Segmentation and classification metrics, in PyTorch and numpy.

Counterpart of ``dat_segmentation_tpu/train/metrics.py``: per-class
intersection and union counts with ignore-index masking, their streaming
sum and the mean IoU over the classes present; top-k accuracy. On the card
``torch.bincount`` is the idiom (the JAX package avoided a scatter only
for the TPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


def intersect_and_union(
    pred: torch.Tensor,
    label: torch.Tensor,
    num_classes: int,
    *,
    ignore_index: int = 255,
    valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(intersection, union, pred_area, label_area), each (num_classes,)
    int64, for integer ``pred`` and ``label`` of one shape."""
    pred, label = pred.reshape(-1).long(), label.reshape(-1).long()
    valid = label != ignore_index
    if valid_mask is not None:
        valid = valid & valid_mask.reshape(-1)
    parked = torch.full_like(label, num_classes)  # invalid pixels: an extra bin
    pred = torch.where(valid, pred, parked)
    label = torch.where(valid, label, parked)
    match = torch.where(pred == label, pred, parked)

    def hist(x):
        return torch.bincount(x, minlength=num_classes + 1)[:num_classes]

    inter, area_pred, area_label = hist(match), hist(pred), hist(label)
    return inter, area_pred + area_label - inter, area_pred, area_label


def miou_from_totals(inter, union, *, eps: float = 1e-10):
    """Mean IoU over classes that appear (union > 0), like mmseg's nanmean;
    returns (miou, per-class IoU with NaN for absent classes)."""
    inter = np.asarray(inter, np.float64)
    union = np.asarray(union, np.float64)
    present = union > 0
    iou = np.where(present, inter / np.maximum(union, eps), np.nan)
    return float(np.nanmean(iou)), iou


@dataclass
class StreamingIoU:
    """Host-side accumulator of per-class counts across steps or images."""

    num_classes: int
    ignore_index: int = 255

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.inter = np.zeros(self.num_classes, np.int64)
        self.union = np.zeros(self.num_classes, np.int64)
        self.area_label = np.zeros(self.num_classes, np.int64)

    def update(self, pred, label, valid_mask=None):
        to_t = lambda a: a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))  # noqa: E731
        i, u, _, al = intersect_and_union(
            to_t(pred), to_t(label), self.num_classes, ignore_index=self.ignore_index,
            valid_mask=None if valid_mask is None else to_t(valid_mask),
        )
        self.inter += i.cpu().numpy()
        self.union += u.cpu().numpy()
        self.area_label += al.cpu().numpy()

    def miou(self) -> float:
        return miou_from_totals(self.inter, self.union)[0]

    def accuracy(self) -> float:
        return float(self.inter.sum() / max(self.area_label.sum(), 1))


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, ks=(1, 5)) -> dict:
    """{k: top-k accuracy} as float32 0-d tensors; soft labels (mixup) are
    argmaxed first. Ties rank as the JAX package's reversed stable argsort
    ranks them: the larger class index first (reference
    train_backbone.py:38-71). The JAX package's public counterpart; the
    train and metric steps count with argmax and ``topk_hits`` instead."""
    if labels.ndim == logits.ndim:
        labels = labels.argmax(-1)
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    return {k: (order[..., :k] == labels[..., None]).any(-1).float().mean() for k in ks}


def topk_hits(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int32 ``[hits1, hits5, total]`` over the rows where ``valid``: a row
    hits top-k when fewer than k classes rank above its label, a class
    ranking above it when its logit is larger or equal at a smaller index
    (``argmax`` and ``lax.top_k``'s order, as the JAX metric step counts)."""
    labels = labels.long()
    at = logits.gather(-1, labels[:, None])
    idx = torch.arange(logits.shape[-1], device=logits.device)
    rank = ((logits > at) | ((logits == at) & (idx < labels[:, None]))).sum(-1)
    k = min(5, logits.shape[-1])
    return torch.stack([((rank < 1) & valid).sum(), ((rank < k) & valid).sum(),
                        valid.sum()]).to(torch.int32)
