"""Iteration-based segmentation trainer, on one card or over the processes
of a ``torch.distributed`` group.

Counterpart of ``dat_segmentation_tpu/train/trainer_seg.py`` (the reference
standalone loop, new_train.py:73-268, and the mmseg 160k recipe): an
infinite shuffled loader whose batches ``device_prefetch`` copies to the
card beside the step -> the train step (``make_train_step``: forward,
backward and AdamW) -> logging every ``log_interval`` -> a checkpoint every
``checkpoint_interval`` and val mIoU every ``eval_interval`` (and at the
end) with best tracking, and one last checkpoint on SIGTERM. The log
lines, scalars, checkpoint names and ``history`` are the JAX package's.
``device`` is the card unless the caller names another. The train IoU
counts stay on the device between log intervals, so no step waits on a
read-back.

Inside a process group (``parallel.init_distributed``; ``tools/train.py
--multihost``) ``cfg.data.batch_size`` is the GLOBAL batch: each process
loads its ``local_batch_size`` share, a disjoint slice of each epoch
(``process_shard_info``), and the step is the global batch's
(``train/train_step.py``) on the mesh ``cfg.mesh_shape``, replicated or,
with ``cfg.fsdp``, sharded over the data axis or (``'spatial'``) the
spatial axis or (``'model'``) split over the model axis; with a
``spatial`` axis, alone or beside a model axis, each image's rows split
over the spatial peers (the step keeps each peer's rows);
``process_shard_info`` is the data coordinate, so model and spatial peers
load the same items. The in-run val runs a whole copy of a sharded
or split model on whole images in each process, as the JAX trainer's,
sharded over the data axis and its counts summed over the data group
(``evaluate_dataset(distributed=True)``), so "best" is decided alike on
every rank; rank 0 logs and writes checkpoints, which are the one-process
format (a sharded or split state is gathered first). Left for later
(ROADMAP.md, Queue 2): overlapping the gradient reduction with the
backward.

Resume restores the model (parameters and BatchNorm statistics), the
AdamW state, the step and the drop-path/dropout generator (and the
classifier's mixup sampler, where the state holds one) from the latest
``ckpt_<step>``. The loader starts again at epoch 0, as the JAX trainer's
does: a resumed run sees other batches than the run it continues would
have seen (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from pathlib import Path
from typing import Optional, Union

import torch

from ..data.ade20k import ADE20KDataset
from ..data.loader import DataLoader, device_prefetch
from ..eval.evaluate import evaluate_dataset
from ..eval.inference import SegInferencer
from ..models.builder import build_model
from ..parallel.mesh import (full_state, is_distributed, is_split, load_full_state,
                             local_batch_size, process_shard_info, resolve_mesh)
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger
from .checkpoint import CheckpointManager, load_pretrained, merge_pretrained
from .metrics import StreamingIoU
from .preemption import PreemptionGuard
from .train_step import TrainState, create_train_state, make_train_step


def _git_hash() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, timeout=5,
            cwd=Path(__file__).parent,
        ).stdout.decode().strip() or None
    except Exception:
        return None


def _dataset_meta(ds) -> dict:
    """CLASSES/PALETTE/git-hash checkpoint meta, like the reference's
    mmseg checkpoint_config meta (tools/train.py:222-233)."""
    meta = {"git": _git_hash()}
    for key in ("CLASSES", "PALETTE"):
        val = getattr(ds, key, None)
        if val is not None:
            meta[key] = [list(v) if isinstance(v, tuple) else v for v in val]
    return meta


def setup_state(cfg, model: torch.nn.Module, *, pretrained: Optional[str] = None) -> TrainState:
    """The train state of ``model`` (optionally merged with ``pretrained``:
    a reference ``.pth`` or a ``ckpt_*`` directory) under ``cfg``'s AdamW
    and schedule."""
    if pretrained:
        merge_pretrained(model, load_pretrained(pretrained, cfg.model))
    return create_train_state(model, cfg)


def _save_tree(st: TrainState) -> dict:
    """The step checkpoint of ``st`` in the one-process format (a sharded
    model's gathered: every rank calls this)."""
    model, optimizer = full_state(st.model, st.optimizer)
    tree = {"step": st.step, "model": model, "optimizer": optimizer,
            "generator": st.generator.get_state()}
    if st.mixup is not None:
        tree["mixup"] = st.mixup.get_state()
    return tree


def _restore_state(st: TrainState, saved: dict) -> TrainState:
    """Load a step checkpoint's model, optimizer, step, generator and mixup
    sampler (where it holds one) into ``st``, in place."""
    load_full_state(st.model, saved["model"], st.optimizer, saved["optimizer"])
    st.step = int(saved["step"])
    st.generator.set_state(saved["generator"])
    if st.mixup is not None and "mixup" in saved:
        st.mixup.set_state(saved["mixup"])
    return st


def eval_model(cfg, model: torch.nn.Module, device) -> torch.nn.Module:
    """``model`` for the in-run val: itself, or a sharded or split model's
    whole copy (its state gathered on every rank)."""
    if not is_split(model):
        return model
    whole = build_model(cfg.model, device=device)
    whole.load_state_dict(full_state(model, everywhere=True)[0])
    return whole


def train_segmentation(
    cfg,
    *,
    pretrained: Optional[str] = None,
    resume: bool = False,
    max_iters: Optional[int] = None,
    eval_max_images: Optional[int] = None,
    dataset_cls=ADE20KDataset,
    eval_batch_size: int = 4,
    device: Optional[Union[str, torch.device]] = None,
):
    """Run the 160k-style iteration loop. Returns (state, history dict)."""
    device = resolve_device(device)
    resolve_mesh(cfg.mesh_shape, cfg.fsdp)
    with torch.random.fork_rng(devices=[]):  # the init's draws leave the global RNG alone
        torch.manual_seed(cfg.seed)
        model = build_model(cfg.model, device=device)
    state = setup_state(cfg, model, pretrained=pretrained)
    crop = cfg.data.crop_size

    work_dir = Path(cfg.work_dir) / cfg.name
    ckpt = CheckpointManager(work_dir)
    logger = MetricLogger(work_dir / "train.log")
    compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    if resume:
        latest = ckpt.latest_step()
        if latest is not None:
            _restore_state(state, ckpt.restore(latest, map_location="cpu"))
            logger.log(f"resumed from iter {latest}")

    train_ds = dataset_cls(
        cfg.data.data_root, "train",
        crop_size=crop, ignore_index=cfg.data.ignore_index, seed=cfg.seed,
    )
    val_ds = dataset_cls(cfg.data.data_root, "val", crop_size=crop)
    loader = DataLoader(
        train_ds, local_batch_size(cfg.data.batch_size), shuffle=True, drop_last=True,
        infinite=True, num_threads=cfg.data.num_workers, seed=cfg.seed,
        shard_info=process_shard_info(),
    )
    batches = device_prefetch(iter(loader), device)

    step_fn = make_train_step(
        model,
        aux_weight=cfg.model.aux_loss_weight,
        ignore_index=cfg.data.ignore_index,
        num_classes=cfg.model.num_classes,
        compute_dtype=compute_dtype,
    )
    total = max_iters or cfg.schedule.max_iters
    train_iou = StreamingIoU(cfg.model.num_classes, cfg.data.ignore_index)
    best_miou = -1.0
    history = {"loss": [], "val_miou": []}
    t0 = time.time()
    it = state.step
    # the IoU counts add up on the device; the host reads them at log_interval
    acc_inter = acc_union = None
    guard = PreemptionGuard()
    for batch in batches:
        if it >= total:
            break
        state, metrics = step_fn(state, batch)
        it += 1

        # graceful preemption (SIGTERM): one last resumable checkpoint, then out
        if guard.should_checkpoint(it):
            logger.log(f"preemption notice: checkpointing at iter {it}")
            ckpt.save(
                it, _save_tree(state),
                metadata=dict({"iter": it, "preempted": True,
                               "config": dataclasses.asdict(cfg)}, **_dataset_meta(train_ds)),
            )
            guard.close()
            break
        if acc_inter is None:
            acc_inter, acc_union = metrics["inter"], metrics["union"]
        else:
            acc_inter = acc_inter + metrics["inter"]
            acc_union = acc_union + metrics["union"]

        if it % cfg.log_interval == 0:
            train_iou.inter += acc_inter.cpu().numpy()
            train_iou.union += acc_union.cpu().numpy()
            acc_inter = acc_union = None
            loss = float(metrics["loss"])
            lr = float(state.schedule(it))
            ips = cfg.data.batch_size * cfg.log_interval / (time.time() - t0)
            logger.log(
                f"iter {it}/{total} loss={loss:.4f} lr={lr:.3e} "
                f"train_mIoU={train_iou.miou()*100:.2f} {ips:.1f} img/s"
            )
            logger.scalars(
                it, loss=loss, lr=lr, train_miou=train_iou.miou(),
                images_per_sec=ips,
                grad_norm=float(metrics["grad_norm"]),
                update_ratio=float(metrics["update_ratio"]),
            )
            history["loss"].append(loss)
            train_iou.reset()
            t0 = time.time()

        if it % cfg.checkpoint_interval == 0:
            ckpt.save(
                it, _save_tree(state),
                metadata=dict({"iter": it, "config": dataclasses.asdict(cfg)},
                              **_dataset_meta(train_ds)),
            )

        if it % cfg.eval_interval == 0 or it == total:
            inf = SegInferencer(
                eval_model(cfg, model, device), num_classes=cfg.model.num_classes,
                mode=cfg.model.test_mode, compute_dtype=compute_dtype, device=device,
            )
            res = evaluate_dataset(
                inf, val_ds, num_classes=cfg.model.num_classes, max_images=eval_max_images,
                batch_size=eval_batch_size, verbose=False, shard_info=process_shard_info(),
                distributed=is_distributed(),
            )
            del inf
            miou = res["mIoU"]
            history["val_miou"].append(miou)
            logger.log(f"iter {it} val mIoU={miou*100:.2f}")
            logger.scalars(it, val_miou=miou)
            if miou > best_miou:
                best_miou = miou
                ckpt.save(
                    "best", {"model": full_state(model)[0]},
                    metadata=dict({"iter": it, "mIoU": miou}, **_dataset_meta(train_ds)),
                )
    batches.close()
    guard.close()
    logger.close()
    # fold the counts still on the device, so the running train mIoU covers
    # every iteration, not only full log_interval windows
    if acc_inter is not None:
        train_iou.inter += acc_inter.cpu().numpy()
        train_iou.union += acc_union.cpu().numpy()
    return state, history
