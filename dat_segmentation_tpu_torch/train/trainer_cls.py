"""Epoch-based ImageNet classifier training, on one card or over the
processes of a ``torch.distributed`` group.

Counterpart of ``dat_segmentation_tpu/train/trainer_cls.py`` (reference
train_backbone.py:85-331): AdamW under a cosine schedule with linear
warmup, stepped per iteration over ``epochs * steps_per_epoch`` with the
warmup given in epochs; the global-norm clip at ``cfg.optimizer.grad_clip``;
mixup/cutmix with the soft-target CE, else the label-smoothing CE; a fresh
shuffled loader each epoch (``epoch=`` keys both the shuffle and each
item's augmentation), its batches copied to the card by
``device_prefetch``; a log line every ``log_interval`` steps and weight
statistics every ``stats_interval``; after each epoch top-1/top-5 over every
val image (the tail batch padded and masked, not dropped); a step
checkpoint every 10 epochs and at the last (tagged by epoch, as the JAX
trainer's), ``best`` and the backbone-only export ``backbone_best`` when
the val top-1 improves; on SIGTERM one last resumable checkpoint. The log
lines, scalars, checkpoint names and ``history`` are the JAX package's.

Inside a ``torch.distributed`` group, as ``trainer_seg.py``:
``cfg.data.batch_size`` is the global batch, each
data coordinate loads its share of every epoch, the step is the global
batch's on the mesh ``cfg.mesh_shape`` (replicated or, with ``cfg.fsdp``,
sharded over the data or the spatial axis or split over the model axis;
over a spatial axis each spatial peer takes its rows of every image, also
beside a model axis), the val is
sharded over the data axis with each item counted once (a process with
fewer pads its last batches with masked rows; model peers run the split
model's forward together, spatial peers their rows of each image, through
``make_cls_metric_step``) and its counts summed over the data group, so
"best" is decided alike on every rank; rank 0 logs and writes.
Resume restores the model, AdamW, the step, the dropout generator and
the mixup sampler from the latest checkpoint and restarts the epoch
``step // steps_per_epoch`` from its beginning.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..data.imagenet import ImageNetDataset
from ..data.loader import DataLoader, device_prefetch
from ..models.builder import build_model
from ..parallel.mesh import (full_state, is_main, is_split, local_batch_size,
                             process_shard_info, resolve_mesh)
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger, weight_stats_on_device
from .checkpoint import (CheckpointManager, load_pretrained, merge_pretrained,
                         save_backbone_only)
from .preemption import PreemptionGuard
from .train_step import create_train_state, make_cls_metric_step, make_train_step
from .trainer_seg import _restore_state, _save_tree


def evaluate_topk(eval_fn, val_ds, batch_size: int) -> np.ndarray:
    """int64 ``[hits1, hits5, total]`` of ``eval_fn`` (``make_cls_metric_step``)
    over every item of ``val_ds``, the tail batch padded to ``batch_size``
    with zeros and masked out. In a process group each process takes its
    shard (``process_shard_info``); the loader pads the shards to one length
    with items of other shards, which are masked out too, so every process
    runs as many batches and each item counts once."""
    rank, world = process_shard_info()
    counts = np.zeros(3, np.int64)
    loader = DataLoader(val_ds, batch_size, drop_last=False, shard_info=(rank, world))
    for bi, batch in enumerate(loader):
        n = int(batch["label"].shape[0])
        image, label = batch["image"], batch["label"].astype(np.int32)
        if n < batch_size:
            pad = batch_size - n
            image = np.concatenate([image, np.zeros((pad, *image.shape[1:]), image.dtype)])
            label = np.concatenate([label, np.zeros((pad,), label.dtype)])
        # the k-th item of this shard is item rank + k * world of the padded epoch
        k = bi * batch_size + np.arange(batch_size)
        valid = (np.arange(batch_size) < n) & (rank + k * world < len(val_ds))
        counts += eval_fn(image, label, valid).cpu().numpy()
    return counts


def _whole_params(model: torch.nn.Module):
    """``model``, or a sharded or split model's parameters gathered on
    every rank."""
    if not is_split(model):
        return model
    names = {n for n, _ in model.named_parameters()}
    return {n: t for n, t in full_state(model, everywhere=True)[0].items() if n in names}


def train_classifier(
    cfg,
    *,
    pretrained: Optional[str] = None,
    resume: bool = False,
    epochs: Optional[int] = None,
    mixup: bool = True,
    steps_per_epoch: Optional[int] = None,
    stats_interval: int = 100,
    device: Optional[Union[str, torch.device]] = None,
):
    """Run the epoch loop. ``epochs`` defaults to ``cfg.schedule.max_iters``
    (the classifier presets give their schedule in epochs);
    ``steps_per_epoch`` caps an epoch (default: the train set's full
    batches). Returns (state, history dict)."""
    device = resolve_device(device)
    resolve_mesh(cfg.mesh_shape, cfg.fsdp)  # the data axis, before local_batch_size
    with torch.random.fork_rng(devices=[]):  # the init's draws leave the global RNG alone
        torch.manual_seed(cfg.seed)
        model = build_model(cfg.model, device=device)
    if pretrained:
        merge_pretrained(model, load_pretrained(pretrained, cfg.model, kind="classifier"))
    size = cfg.data.crop_size[0]
    bs = local_batch_size(cfg.data.batch_size)

    train_ds = ImageNetDataset(cfg.data.data_root, "train", size=size, seed=cfg.seed)
    val_ds = ImageNetDataset(cfg.data.data_root, "val", size=size)
    n_epochs = epochs or cfg.schedule.max_iters  # the cls schedule is in epochs
    spe = steps_per_epoch or max(len(train_ds) // cfg.data.batch_size, 1)
    # the per-iteration schedule over the total steps (train_backbone.py:250-264)
    sched = dataclasses.replace(cfg.schedule, max_iters=n_epochs * spe,
                                warmup_iters=cfg.schedule.warmup_iters * spe)
    state = create_train_state(model, dataclasses.replace(cfg, schedule=sched))

    work_dir = Path(cfg.work_dir) / cfg.name
    ckpt = CheckpointManager(work_dir)
    logger = MetricLogger(work_dir / "train.log")
    compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if resume:
        latest = ckpt.latest_step()
        if latest is not None:
            _restore_state(state, ckpt.restore(latest, map_location="cpu"))
            logger.log(f"resumed from epoch checkpoint {latest}")

    step_fn = make_train_step(model, task="cls", num_classes=cfg.model.num_classes,
                              compute_dtype=compute_dtype, mixup=mixup)
    eval_fn = make_cls_metric_step(model, compute_dtype=compute_dtype)

    best_acc = -1.0
    history = {"train_loss": [], "val_acc1": [], "val_acc5": []}
    start_epoch = state.step // spe
    guard = PreemptionGuard()
    preempted = False
    metrics = None
    for epoch in range(start_epoch, n_epochs):
        loader = DataLoader(train_ds, bs, shuffle=True, drop_last=True,
                            num_threads=cfg.data.num_workers, seed=cfg.seed, epoch=epoch,
                            shard_info=process_shard_info())
        batches = device_prefetch(iter(loader), device)
        t0, seen = time.time(), 0
        for bi, batch in enumerate(batches):
            if steps_per_epoch and bi >= steps_per_epoch:
                break
            state, metrics = step_fn(state, batch)
            seen += cfg.data.batch_size
            # graceful preemption: a resumable checkpoint; the resume restarts
            # this epoch from its beginning (step // spe)
            if guard.should_checkpoint(state.step):
                logger.log(f"preemption notice: checkpointing at step {state.step} "
                           f"(epoch {epoch})")
                ckpt.save(epoch + 1, _save_tree(state),
                          metadata={"epoch": epoch, "preempted": True})
                preempted = True
                break
            if (bi + 1) % cfg.log_interval == 0:
                logger.log(
                    f"epoch {epoch} it {bi + 1} loss={float(metrics['loss']):.4f} "
                    f"acc={float(metrics['acc1']) * 100:.2f} "
                    f"{seen / (time.time() - t0):.1f} img/s"
                )
            if (bi + 1) % stats_interval == 0:
                # per-parameter mean/std/L2 and the grad/update scalars at the
                # reference's TensorBoard cadence (train_backbone.py:73-83,131-135)
                flat = {f"w/{name}/{key}": val
                        for name, st in weight_stats_on_device(_whole_params(model)).items()
                        for key, val in st.items()}
                logger.scalars(state.step, loss=float(metrics["loss"]),
                               grad_norm=float(metrics["grad_norm"]),
                               update_ratio=float(metrics["update_ratio"]), **flat)
        batches.close()
        if preempted:
            break
        if metrics is not None:
            history["train_loss"].append(float(metrics["loss"]))

        # validation: top-1/5 over every val image (train_backbone.py:145-170)
        hits1, hits5, total = (int(c) for c in evaluate_topk(eval_fn, val_ds, bs))
        acc1, acc5 = hits1 / max(total, 1), hits5 / max(total, 1)
        history["val_acc1"].append(acc1)
        history["val_acc5"].append(acc5)
        logger.log(f"epoch {epoch} val acc1={acc1 * 100:.2f} acc5={acc5 * 100:.2f}")
        logger.scalars(state.step, val_acc1=acc1, val_acc5=acc5)

        if (epoch + 1) % 10 == 0 or epoch == n_epochs - 1:
            ckpt.save(epoch + 1, _save_tree(state), metadata={"epoch": epoch, "acc1": acc1})
        if acc1 > best_acc:
            best_acc = acc1
            whole = full_state(model)[0]
            ckpt.save("best", {"model": whole}, metadata={"epoch": epoch, "acc1": acc1})
            if is_main():
                save_backbone_only(work_dir / "backbone_best", whole)
    guard.close()
    logger.close()
    return state, history
