"""Training CLI of the port: a preset or an mmseg config file, ADE20K or
ImageNet, on the card.

    python -m dat_segmentation_tpu_torch.tools.train upn_tiny_160k_dp03_lr6 \\
        --data-root /data/ade20k [--max-iters N] [--resume] [--pretrained X] \\
        [--work-dir DIR] [--set key=value ...] [--device cpu]
    python -m dat_segmentation_tpu_torch.tools.train cls_tiny_imagenet \\
        --data-root /data/imagenet [--epochs N] [--no-mixup] ...
    torchrun --nproc_per_node=8 -m dat_segmentation_tpu_torch.tools.train \\
        upn_tiny_160k_dp03_lr6 --multihost --data-root /data/ade20k ...

The port's ``tools/train.py`` (the JAX package's): a ``ClsHead`` config
trains with ``train/trainer_cls.py`` (``--epochs``, ``--no-mixup``), any
other with ``train/trainer_seg.py`` (``--max-iters``, ``--eval-batch-size``). ``config`` is a preset name or a
``.py`` config in mmseg's dict form (its ``_base_`` files merged;
``configs/mmseg_compat.py``). ``--set`` takes dotted overrides, as mmseg's
``--cfg-options`` (``--set data.batch_size=8 schedule.max_iters=80000``),
each value read as a Python literal where it parses as one.
``--pretrained`` is a reference ``.pth`` or a ``ckpt_*`` directory of this
trainer; ``--resume`` continues from the latest ``ckpt_<step>`` in the
work dir. ``--device`` is the card unless named (``cpu`` runs the plain
PyTorch versions). ``--multihost`` joins the process group torchrun
describes (``parallel.init_distributed``: NCCL on the cards, one process a
card, gloo with ``--device cpu``); the config's ``data.batch_size`` is then
the global batch, and ``fsdp=True`` (``--set fsdp=True``) shards the
parameters and AdamW's moments; ``--set "mesh_shape={'data': X, 'model':
Y}" fsdp=model`` splits the model over the model axis (tensor
parallelism, ``parallel/model_axis.py``), ``--set "mesh_shape={'data':
X, 'spatial': S}"`` splits each image's rows over S processes
(``parallel/spatial.py``: crops larger than one card's activations hold),
and ``--set "mesh_shape={'data': X, 'model': Y, 'spatial': S}"
fsdp=model`` does both over X·Y·S processes (rank (d·Y + m)·S + s, the
dict's order as the JAX ``make_mesh``); ``fsdp=spatial`` shards the
parameters and AdamW's moments over the spatial peers instead (a rank
holds 1/S of them), with or without a model axis. ``main(argv)`` returns
the trainer's (state, history). ``--diff-seed`` is taken, as the JAX CLI
takes it, and changes nothing (see its help).
"""

from __future__ import annotations

import argparse
import ast
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DAT segmentation training (PyTorch port)")
    p.add_argument("config", help="preset name or python config file")
    p.add_argument("--data-root", required=True)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--pretrained", default=None,
                   help="reference torch .pth or a ckpt_* directory of this trainer")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the work dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diff-seed", action="store_true",
                   help="the reference's per-rank seed offset; a no-op here, as in the JAX "
                        "CLI: dropout and drop-path masks are drawn over the global batch "
                        "(parallel/mesh.py) and each item's augmentation is keyed by (seed, "
                        "epoch, global index), so every sample already draws its own")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None, help="classifier only")
    p.add_argument("--no-mixup", action="store_true", help="classifier only")
    p.add_argument("--eval-batch-size", type=int, default=1,
                   help="whole-mode images a forward in the in-run eval")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's process group (data parallel over its processes)")
    return p.parse_args(argv)


def load_config(name_or_path: str):
    """A preset, or a ``TrainConfig`` around the model of an mmseg-style
    ``.py`` config."""
    from ..configs import get_config
    from ..configs.mmseg_compat import load_python_config, model_config_from_mmseg
    from ..configs.schema import TrainConfig

    if name_or_path.endswith(".py"):
        model = model_config_from_mmseg(load_python_config(name_or_path))
        return TrainConfig(name=Path(name_or_path).stem, model=model)
    return get_config(name_or_path)


def apply_overrides(cfg, pairs: Sequence[str]):
    """``key=value`` dotted overrides, values read as Python literals where
    they parse."""
    from ..configs.schema import replace

    for pair in pairs:
        key, _, raw = pair.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        cfg = replace(cfg, **{key: value})
    return cfg


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    from ..configs.schema import replace
    from ..train.trainer_seg import train_segmentation
    from ..parallel import init_distributed
    from ..utils.device import resolve_device

    device = init_distributed(device=args.device) if args.multihost else resolve_device(args.device)
    cfg = load_config(args.config)
    cfg = replace(cfg, **{"data.data_root": args.data_root, "seed": args.seed})
    if args.diff_seed:
        print("--diff-seed: a no-op here (see --help): dropout masks and augmentations are "
              "drawn over the global batch, already distinct for every sample")
    if args.work_dir:
        cfg = replace(cfg, work_dir=args.work_dir)
    cfg = apply_overrides(cfg, args.set)
    if cfg.model.decode_head.type == "ClsHead":
        from ..train.trainer_cls import train_classifier

        return train_classifier(
            cfg, pretrained=args.pretrained, resume=args.resume, epochs=args.epochs,
            mixup=not args.no_mixup, device=device,
        )
    return train_segmentation(
        cfg, pretrained=args.pretrained, resume=args.resume, max_iters=args.max_iters,
        eval_batch_size=args.eval_batch_size, device=device,
    )


if __name__ == "__main__":
    main()
