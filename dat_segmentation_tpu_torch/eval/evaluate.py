"""Dataset-level evaluation: streaming mIoU over ADE20K val, in PyTorch.

The port's ``evaluate_dataset`` (``dat_segmentation_tpu/eval/evaluate.py:258``,
the reference's ``tools/test.py --eval mIoU [--aug-test]``): per image,
``load_raw``, ``SegInferencer.predict`` at the original resolution
against the original-resolution GT, per-class intersection and union
summed in int64, then mIoU, aAcc and the per-class IoU and Acc.

* ``batch_size=1``, slide mode, or ``aug_test``: the per-image loop.
* ``batch_size>1`` in whole mode without TTA: consecutive images whose
  resized inputs have one shape run ``batch_size`` to a forward. The
  port runs every image at its true shape, so there are no pad buckets
  (the JAX package pads to buckets and runs its exact path, which is
  proven equal to the true-shape forward); each image's logits are
  resized to its original size and argmaxed as ``predict`` does.

The JAX package's ``postproc_workers`` (host threads overlapping the
resize and argmax with the next forward) has no counterpart: the port's
resize and argmax run on the device, so there is no host postproc to
overlap. ``shard_info`` gives a process its images; ``distributed=True``
sums the counts of every process of a ``torch.distributed`` group in
int64 at the end (JAX ``evaluate.py:40-70``, one all-reduce over the gloo
control group of ``parallel/mesh.py``), so every process returns the whole
set's result; alone it changes nothing. ``merge_shard_results`` sums the
results of separate sharded runs offline.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from ..parallel import mesh
from ..train.metrics import StreamingIoU, miou_from_totals
from .inference import MS_RATIOS, SegInferencer


def _per_image(inferencer, dataset, indices, finish, *, img_scale, ratios, flip, keep_ratio):
    for idx in indices:
        raw, gt = dataset.load_raw(idx)
        pred = inferencer.predict(raw, img_scale=img_scale, ratios=ratios, flip=flip,
                                  keep_ratio=keep_ratio, ori_shape=gt.shape)
        finish(idx, pred, gt)


def _batched(inferencer, dataset, indices, finish, *, img_scale, keep_ratio, batch_size):
    group = []  # (idx, normalised input on the device, gt) of one input shape

    def flush():
        preds = inferencer._predict_whole_batch([inp for _, inp, _ in group],
                                                [gt.shape for _, _, gt in group])
        for (idx, _, gt), pred in zip(group, preds):
            finish(idx, pred, gt)
        group.clear()

    for idx in indices:
        raw, gt = dataset.load_raw(idx)
        (inp, _), = inferencer.tta_inputs(raw, img_scale=img_scale, keep_ratio=keep_ratio)
        if group and inp.shape != group[0][1].shape:
            flush()
        group.append((idx, inp, gt))
        if len(group) == batch_size:
            flush()
    if group:
        flush()


def _reduce_across_processes(iou: StreamingIoU, done: int) -> int:
    """Sum ``iou``'s counts (in place) and the image count over the data
    group (model and spatial peers evaluate the same images); returns the
    summed image count."""
    c = iou.num_classes
    totals = mesh.all_reduce_host(np.concatenate([iou.inter, iou.union, iou.area_label, [done]]),
                                  data_axis=True)
    iou.inter, iou.union, iou.area_label = totals[:c], totals[c:2 * c], totals[2 * c:3 * c]
    return int(totals[-1])


def evaluate_dataset(
    inferencer: SegInferencer,
    dataset,
    *,
    num_classes: int = 150,
    ignore_index: int = 255,
    img_scale=(2048, 512),
    aug_test: bool = False,
    keep_ratio: bool = True,
    max_images: Optional[int] = None,
    shard_info: Optional[tuple] = None,
    batch_size: int = 1,
    distributed: bool = False,
    log_interval: int = 50,
    verbose: bool = True,
    on_pred=None,
) -> dict:
    """Returns {'mIoU', 'aAcc', 'per_class_iou', 'per_class_acc',
    'num_images', 'inter', 'union'} as the JAX package does (counts as
    int64 sums, absent classes None).

    ``aug_test``: ``MS_RATIOS`` with horizontal flip. ``shard_info``
    (rank, world): this process takes images rank, rank + world, ... of
    the first ``max_images``; ``distributed``: the counts summed over the
    processes of the group. ``on_pred(idx, pred)`` fires once an image
    with its original-resolution int32 class map."""
    ratios: Sequence[float] = MS_RATIOS if aug_test else (1.0,)
    flip = bool(aug_test)
    iou = StreamingIoU(num_classes, ignore_index)
    rank, world = shard_info or (0, 1)
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    indices = range(rank, n, world)
    done = 0
    t0 = time.time()

    def finish(idx, pred, gt):
        nonlocal done
        iou.update(pred, gt)
        if on_pred is not None:
            on_pred(idx, pred)
        done += 1
        if verbose and done % log_interval == 0:
            print(f"[eval] {done} imgs, {done / (time.time() - t0):.2f} img/s, "
                  f"running mIoU={iou.miou() * 100:.2f}")

    if batch_size > 1 and inferencer.mode == "whole" and not aug_test:
        _batched(inferencer, dataset, indices, finish, img_scale=img_scale,
                 keep_ratio=keep_ratio, batch_size=batch_size)
    else:
        _per_image(inferencer, dataset, indices, finish, img_scale=img_scale, ratios=ratios,
                   flip=flip, keep_ratio=keep_ratio)
    if distributed and mesh.is_distributed():
        done = _reduce_across_processes(iou, done)
    _, per_class = miou_from_totals(iou.inter, iou.union)
    # per-class Acc = inter / GT area (mmseg's per-class table columns)
    with np.errstate(invalid="ignore", divide="ignore"):
        per_acc = np.where(iou.area_label > 0, iou.inter / np.maximum(iou.area_label, 1), np.nan)
    return {
        "mIoU": iou.miou(),
        "aAcc": iou.accuracy(),
        "per_class_iou": [None if np.isnan(v) else float(v) for v in per_class],
        "per_class_acc": [None if np.isnan(v) else float(v) for v in per_acc],
        "num_images": done,
        "inter": iou.inter.tolist(),
        "union": iou.union.tolist(),
    }


def merge_shard_results(results: Sequence[dict], num_classes: int = 150) -> dict:
    """Sum per-shard counts (an offline collection of sharded runs)."""
    inter = np.zeros(num_classes, np.int64)
    union = np.zeros(num_classes, np.int64)
    n = 0
    for r in results:
        inter += np.asarray(r["inter"], np.int64)
        union += np.asarray(r["union"], np.int64)
        n += r["num_images"]
    miou, per_class = miou_from_totals(inter, union)
    return {
        "mIoU": miou,
        "per_class_iou": [None if np.isnan(v) else float(v) for v in per_class],
        "num_images": n,
    }
