"""Dataset-level evaluation: streaming mIoU over ADE20K val, in PyTorch.

The port's ``evaluate_dataset`` (``dat_segmentation_tpu/eval/evaluate.py:258``,
the reference's ``tools/test.py --eval mIoU [--aug-test]``): per image,
``load_raw``, ``SegInferencer.predict`` at the original resolution
against the original-resolution GT, per-class intersection and union
summed in int64, then mIoU, aAcc and the per-class IoU and Acc.

* ``batch_size=1`` or slide mode: the per-image loop.
* ``batch_size>1`` in whole mode with the inferencer's ``bucket`` > 1:
  the JAX package's bucket batcher (``_BucketBatcher`` and
  ``_evaluate_batched``, ``evaluate.py:72-240`` there). Every test-time
  input (each ratio and flip of each image) is keyed by its shape padded
  to the bucket; a key's inputs run ``batch_size`` to a forward, the
  batch fixed (empty slots zeros of the full extent), with ``valid_hw``
  when some input is partial and ``exact`` is on
  (``SegInferencer.forward_batch``). Each input's logits come back at
  its true size (``SegInferencer._bucket_logits``); without TTA they are
  resized to the original size and argmaxed, with TTA flipped back,
  resized, soft-maxed and summed into the image's accumulator until all
  its variants are in. At most ``max(2 * batch_size, 8)`` images wait for
  their variants; beyond that every bucket is flushed.
* ``batch_size>1`` in whole mode at ``bucket`` 1 (each image at its true
  shape): without TTA, consecutive images whose resized inputs have one
  shape run ``batch_size`` to a forward; with TTA the per-image loop.
  Each image's logits are resized to its original size and argmaxed as
  ``predict`` does.

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
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh
from ..train.metrics import StreamingIoU, miou_from_totals
from .inference import MS_RATIOS, SegInferencer, _resize, round_up


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


class _BucketBatcher:
    """Test-time inputs grouped by their shape padded to the inferencer's
    bucket, run ``batch_size`` to a forward of one (batch, hb, wb) shape;
    ``on_logits(meta, logits)`` takes each input's (h, w, C) logits."""

    def __init__(self, inferencer: SegInferencer, batch_size: int, on_logits):
        self.inf = inferencer
        self.batch_size = batch_size
        self.on_logits = on_logits
        self.buffers = defaultdict(list)  # (hb, wb) -> [(img, meta)]

    def add(self, img, meta) -> None:
        b = self.inf.bucket
        key = (round_up(img.shape[0], b), round_up(img.shape[1], b))
        buf = self.buffers[key]
        buf.append((img, meta))
        if len(buf) >= self.batch_size:
            self._flush(key)

    def _flush(self, key) -> None:
        entries = self.buffers.pop(key, [])
        if not entries:
            return
        x, valid = self.inf._padded([img for img, _ in entries], key, self.batch_size)
        exact = self.inf.exact and any(tuple(img.shape[:2]) != key for img, _ in entries)
        small = self.inf.forward_batch(x, valid_hw=valid if exact else None)
        for i, (img, meta) in enumerate(entries):
            self.on_logits(meta, self.inf._bucket_logits(small[i], tuple(img.shape[:2]), key,
                                                         exact))

    def flush_all(self) -> None:
        for key in list(self.buffers):
            self._flush(key)


@torch.inference_mode()
def _bucketed(inferencer, dataset, indices, finish, *, img_scale, ratios, flip, keep_ratio,
              batch_size):
    n_aug = len(ratios) * (2 if flip else 1)
    pending = {}  # idx -> [prob sum, variants in, gt]

    def on_logits(meta, logits):
        idx, do_flip, ori = meta
        if n_aug == 1:
            finish(idx, inferencer._class_map(logits, ori), pending.pop(idx)[2])
            return
        if do_flip:
            logits = torch.flip(logits, dims=[1])
        if tuple(logits.shape[:2]) != ori:
            logits = _resize(logits, ori)
        acc = pending[idx]
        acc[0] += torch.softmax(logits, dim=-1)
        acc[1] += 1
        if acc[1] == n_aug:
            finish(idx, acc[0].div_(n_aug).argmax(-1).to(torch.int32).cpu().numpy(), acc[2])
            del pending[idx]

    batcher = _BucketBatcher(inferencer, batch_size, on_logits)
    max_pending = max(2 * batch_size, 8)  # each holds an (H, W, C) float32 sum on the device
    for idx in indices:
        raw, gt = dataset.load_raw(idx)
        ori = tuple(gt.shape)
        pending[idx] = [None if n_aug == 1 else torch.zeros(
            *ori, inferencer.num_classes, device=inferencer.device), 0, gt]
        for inp, do_flip in inferencer.tta_inputs(raw, img_scale=img_scale, ratios=ratios,
                                                  flip=flip, keep_ratio=keep_ratio):
            batcher.add(inp, (idx, do_flip, ori))
        if len(pending) > max_pending:
            batcher.flush_all()
    batcher.flush_all()
    assert not pending, f"{len(pending)} images never finished"


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

    if batch_size > 1 and inferencer.mode == "whole" and inferencer.bucket > 1:
        _bucketed(inferencer, dataset, indices, finish, img_scale=img_scale, ratios=ratios,
                  flip=flip, keep_ratio=keep_ratio, batch_size=batch_size)
    elif batch_size > 1 and inferencer.mode == "whole" and not aug_test:
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
