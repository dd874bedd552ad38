"""Losses, in PyTorch.

Counterpart of ``dat_segmentation_tpu/train/losses.py``: pixel
cross-entropy with ignore index 255 as the mean over the pixels that are
not ignored (0 when every pixel is), the 0.4-weighted auxiliary loss, the
soft-target CE of mixup and label-smoothing CE. Logits come in NHWC (or
(N, C)) with the classes last and are taken in float32, as in the JAX
package. On the card ``F.cross_entropy`` with ``ignore_index`` is the
idiom; the JAX package's gather-free masked sum was a TPU workaround.

Inside a process group each process's loss is its local sum over the
GLOBAL count (of valid pixels, one int64 all-reduce for the main and the
auxiliary CE; of samples for the classifier's), so the sum of the
processes' losses, and of their gradients, is the JAX package's mean over
the global batch. (A mean of per-process means is not, where processes
hold different numbers of ignored pixels.) On a mesh with a model axis the
counts and the sum are over the data group (``parallel/mesh.py``): model
peers hold the same rows. On a mesh with a spatial axis the labels are row
shards: the pixel counts are over data × spatial (of the rank's model
coordinate: its model peers hold the same rows). The classifier's logits
are replicated on the spatial peers: its loss divides by the data axis's
global batch and by S, so that its parts (and their gradients) summed
over data × spatial are the mean once (``parallel/spatial.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce, is_distributed, layout, process_shard_info


def valid_count(labels: torch.Tensor, *, ignore_index: int = 255) -> torch.Tensor:
    """int64 count of the pixels that are not ignored, over the global batch
    inside a process group (over its row shards beside a spatial axis)."""
    count = (labels != ignore_index).sum()
    return all_reduce(count, rows=True) if is_distributed() else count


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, *, ignore_index: int = 255,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """logits (..., C), labels (...) int: CE summed over non-ignored pixels
    over ``count`` (default ``valid_count(labels)``): their mean."""
    flat = logits.float().reshape(-1, logits.shape[-1])
    lbl = labels.reshape(-1).long()
    nll = F.cross_entropy(flat, lbl, ignore_index=ignore_index, reduction="sum")
    if count is None:
        count = valid_count(lbl, ignore_index=ignore_index)
    return nll / count.clamp_min(1)


def segmentation_loss(
    logits: torch.Tensor,
    aux_logits: Optional[torch.Tensor],
    labels: torch.Tensor,
    *,
    aux_weight: float = 0.4,
    ignore_index: int = 255,
) -> torch.Tensor:
    """main CE + aux_weight * aux CE."""
    count = valid_count(labels, ignore_index=ignore_index)
    loss = cross_entropy_loss(logits, labels, ignore_index=ignore_index, count=count)
    if aux_logits is not None:
        loss = loss + aux_weight * cross_entropy_loss(aux_logits, labels,
                                                      ignore_index=ignore_index, count=count)
    return loss


def _batch_mean(per_row: torch.Tensor) -> torch.Tensor:
    """The mean over the batch; inside a process group this process's sum
    over the global batch size (the processes' batches are equal), and
    over the spatial axis's size (each spatial peer holds the rows)."""
    if not is_distributed():
        return per_row.mean()
    return per_row.sum() / (per_row.shape[0] * process_shard_info()[1] * layout().spatial)


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: batch mean of -sum(t * log_softmax)."""
    return _batch_mean(torch.sum(-targets * F.log_softmax(logits.float(), dim=-1), dim=-1))


def label_smoothing_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, *, smoothing: float = 0.1
) -> torch.Tensor:
    """torch ``CrossEntropyLoss(label_smoothing=s)`` on (N, C) logits."""
    if not is_distributed():
        return F.cross_entropy(logits.float(), labels.long(), label_smoothing=smoothing)
    return _batch_mean(F.cross_entropy(logits.float(), labels.long(), label_smoothing=smoothing,
                                       reduction="none"))
