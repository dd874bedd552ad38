"""Evaluation CLI of the port: a config, a checkpoint and ADE20K val ->
mIoU, on the card.

    python -m dat_segmentation_tpu_torch.tools.test fpn_tiny_80k_dp04_lr2 CKPT.pth \\
        --data-root /data/ade20k [--aug-test] [--mode slide] [--out r.json] \\
        [--pad-bucket 32 [--no-exact]] [--show-dir DIR] [--format-dir DIR] \\
        [--set key=value ...]

The port's ``tools/test.py`` (the JAX package's ``tools/test.py:22-61``)
for what it has: the config is a preset or an mmseg-style ``.py`` file,
with ``--set`` overrides, as the train CLI reads them
(``tools/train.py:load_config``, ``apply_overrides``). ``CKPT`` is a
reference ``.pth`` (mmseg's head names or the standalone ones), or a
``ckpt_*`` directory the port's trainer wrote, merged tolerantly, with the
report printed. ``--aug-test`` uses the reference's ratios
(0.5 ... 1.75) and horizontal flip. It prints the per-class table and
mIoU, and writes the result dict (mIoU, aAcc, per-class IoU and Acc,
``inter``, ``union``, ``num_images``) to ``--out``. ``--device`` is the
card unless named (``cpu`` runs the plain PyTorch versions).

``--distributed`` joins the process group torchrun describes
(``parallel.init_distributed``): each process evaluates its shard of the
images and the counts are summed, so every process holds the whole
result; rank 0 prints it and writes ``--out``.

``--show-dir`` writes each prediction as a colour PNG (the ADE20K palette
at 150 classes, else a palette drawn from seed 42, as the JAX CLI's),
``--format-dir`` as the submission's greyscale PNG (label + 1, the ADE20K
convention); both from ``evaluate_dataset``'s ``on_pred``, in the one
inference pass, named after the image, by ``data/image_io.py:write_png``
(no cv2).

The JAX CLI's command lines run here too, to the JAX CLI's results.
``--eval mIoU`` names the one metric there is. ``--pad-bucket N`` pads the
whole-mode inputs to multiples of N and batches ``--batch-size`` of one
padded shape a forward (``eval/evaluate.py``'s bucket batcher), through
the exact padded forward (``ops/valid_extent.py``), whose result is the
true-shape forward's. Unset or 1, each image runs at its true shape,
which gives the result of the JAX CLI's default (bucket 32, exact); that
is the default here, as it runs K1 on the card while the exact padded
forward runs the attention's composite (the JAX gate). ``--no-exact`` is
the JAX package's plain zero-pad path in whole mode: the padded forward's
logits resized to the padded size and sliced; without ``--pad-bucket`` it
takes the JAX CLI's default bucket, 32. Slide mode forwards a partial
window at its true extent either way. ``--postproc-workers`` is taken and changes
nothing: the port resizes and argmaxes on the device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.ade20k import ADE20K_CLASSES, ADE20K_NUM_CLASSES, ADE20K_PALETTE, ADE20KDataset
from ..data.image_io import write_png
from ..eval.evaluate import evaluate_dataset
from ..eval.inference import SegInferencer
from ..models.builder import build_model
from ..parallel import init_distributed, process_shard_info
from ..train.checkpoint import load_pretrained, merge_pretrained
from ..utils.device import resolve_device
from .train import apply_overrides, load_config


JAX_PAD_BUCKET = 32  # the JAX CLI's --pad-bucket default


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DAT segmentation evaluation (PyTorch port)")
    p.add_argument("config", help="preset name or python config file")
    p.add_argument("checkpoint", help="reference torch .pth or a ckpt_* directory")
    p.add_argument("--data-root", required=True)
    p.add_argument("--eval", default="mIoU", choices=["mIoU"], help="the metric (mIoU only)")
    p.add_argument("--aug-test", action="store_true", help="multi-scale + flip TTA")
    p.add_argument("--mode", default=None, choices=[None, "whole", "slide"])
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--out", default=None, help="json results path")
    p.add_argument("--show-dir", default=None, help="write colour prediction maps here")
    p.add_argument("--format-dir", default=None,
                   help="write submission-format greyscale maps (label+1, the ADE20K convention)")
    p.add_argument("--shard", default=None, metavar="RANK/WORLD",
                   help="evaluate a shard (merge with merge_shard_results)")
    p.add_argument("--batch-size", type=int, default=4,
                   help="whole-mode inputs a forward, of one (padded) shape (1 = per image)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides (must match the checkpoint)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group: shard the images, sum the counts")
    p.add_argument("--pad-bucket", type=int, default=None,
                   help="whole-mode pad-to multiple, images of one padded shape batched "
                        "(unset or 1: each image at its true shape, equal to the exact "
                        "padded forward)")
    p.add_argument("--postproc-workers", type=int, default=None,
                   help="the JAX CLI's flag; changes nothing: the port resizes and argmaxes "
                        "on the device")
    p.add_argument("--no-exact", action="store_true",
                   help="the plain zero-pad forward instead of the exact padded one "
                        f"(bucket {JAX_PAD_BUCKET} unless --pad-bucket)")
    return p.parse_args(argv)


def pad_bucket(args) -> int:
    """The whole-mode bucket of a command line: ``--pad-bucket``; unset,
    1 (the true shape) or, with ``--no-exact``, the JAX CLI's default."""
    if args.pad_bucket is not None:
        return args.pad_bucket
    return JAX_PAD_BUCKET if args.no_exact else 1


def _png_writers(args, ds, num_classes: int):
    """``on_pred`` for ``--show-dir`` and ``--format-dir`` (None without
    either): the JAX CLI's maps, written without cv2."""
    writers = []
    if args.format_dir:
        fmt_dir = Path(args.format_dir)
        fmt_dir.mkdir(parents=True, exist_ok=True)
        writers.append(lambda idx, pred: write_png(
            fmt_dir / f"{Path(ds.images[idx]).stem}.png", (pred + 1).astype(np.uint8)))
    if args.show_dir:
        show_dir = Path(args.show_dir)
        show_dir.mkdir(parents=True, exist_ok=True)
        if num_classes == ADE20K_NUM_CLASSES:
            palette = np.asarray(ADE20K_PALETTE, np.uint8)
        else:
            palette = np.random.RandomState(42).randint(0, 255, (num_classes, 3)).astype(np.uint8)
        writers.append(lambda idx, pred: write_png(
            show_dir / f"{Path(ds.images[idx]).stem}.png", palette[pred]))
    if not writers:
        return None

    def on_pred(idx, pred):
        for write in writers:
            write(idx, pred)

    return on_pred


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = init_distributed(device=args.device) if args.distributed else resolve_device(args.device)
    cfg = load_config(args.config)
    cfg = apply_overrides(cfg, args.set)
    torch.manual_seed(0)  # keys the checkpoint lacks stay at a reproducible init
    model = build_model(cfg.model, device=device)
    state = load_pretrained(args.checkpoint, cfg.model)
    _, report = merge_pretrained(model, state, return_report=True)
    print(f"[load] {args.checkpoint}: {len(state)} tensors; "
          + ", ".join(f"{k} {len(v)}" for k, v in report.items()))
    inferencer = SegInferencer(
        model, num_classes=cfg.model.num_classes, mode=args.mode or cfg.model.test_mode,
        crop_size=cfg.model.crop_size, stride=cfg.model.slide_stride,
        slide_batch=args.batch_size, bucket=pad_bucket(args), exact=not args.no_exact,
        device=device,
    )
    del model
    shard_info = tuple(map(int, args.shard.split("/"))) if args.shard else None
    if args.distributed:
        shard_info = process_shard_info()
    ds = ADE20KDataset(args.data_root, "val")
    res = evaluate_dataset(
        inferencer, ds, num_classes=cfg.model.num_classes,
        img_scale=cfg.data.img_scale, aug_test=args.aug_test, max_images=args.max_images,
        shard_info=shard_info, batch_size=args.batch_size, distributed=args.distributed,
        on_pred=_png_writers(args, ds, cfg.model.num_classes),
    )
    if args.distributed and shard_info[0] != 0:
        return res  # rank 0 reports
    names = (ADE20K_CLASSES if cfg.model.num_classes == len(ADE20K_CLASSES)
             else [str(i) for i in range(cfg.model.num_classes)])
    width = max(len(n) for n in names)
    print(f"{'Class':<{width}}  {'IoU':>6}  {'Acc':>6}")
    for name, iou_v, acc_v in zip(names, res["per_class_iou"], res["per_class_acc"]):
        iou_s = "nan" if iou_v is None else f"{iou_v * 100:.2f}"
        acc_s = "nan" if acc_v is None else f"{acc_v * 100:.2f}"
        print(f"{name:<{width}}  {iou_s:>6}  {acc_s:>6}")
    print(f"mIoU: {res['mIoU'] * 100:.2f}  aAcc: {res['aAcc'] * 100:.2f}")
    if args.out:
        Path(args.out).write_text(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
