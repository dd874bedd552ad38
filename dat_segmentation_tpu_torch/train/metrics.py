"""Segmentation metrics, in PyTorch and numpy.

Counterpart of ``dat_segmentation_tpu/train/metrics.py``: per-class
intersection and union counts with ignore-index masking, their streaming
sum and the mean IoU over the classes present. On the card
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
