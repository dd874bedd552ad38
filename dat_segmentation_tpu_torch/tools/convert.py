"""Convert a reference torch checkpoint (``.pth``) to the port's format.

    python -m dat_segmentation_tpu_torch.tools.convert upn_tiny_160k_dp03_lr6 \\
        dat_upn_tiny.pth out_dir/
    python -m dat_segmentation_tpu_torch.tools.convert cls_tiny_imagenet \\
        dat_pp_tiny_in1k.pth out_dir/ --kind classifier

The port's ``tools/convert.py`` (the JAX package's converts to orbax). The
``.pth`` (mmseg's head names or the standalone ones; ``--kind backbone``
for a backbone checkpoint, ``classifier`` for an ImageNet one) is merged
into the model the config builds with seed 0, as ``merge_pretrained``
does, and its report is printed; the merged ``state_dict`` is written as
a ``ckpt_*``-style directory (``state.pt`` holding ``{"model": ...}``),
which ``tools/test.py``, ``tools/export.py`` and ``train --pretrained``
read. Converting once saves the translation at every start. A shape
mismatch (a checkpoint of another config) fails.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="reference .pth -> the port's checkpoint directory")
    p.add_argument("config", help="preset name or python config file")
    p.add_argument("checkpoint", help="reference torch .pth")
    p.add_argument("output", help="checkpoint directory to write")
    p.add_argument("--kind", default="segmentor",
                   choices=["segmentor", "backbone", "classifier"])
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    args = parse_args(argv)
    import torch

    from ..models.builder import build_model
    from ..train.checkpoint import STATE_FILE, load_pretrained, merge_pretrained
    from .train import apply_overrides, load_config

    out = Path(args.output).absolute()
    if out.exists():
        raise SystemExit(f"refusing to overwrite existing {out}")
    cfg = apply_overrides(load_config(args.config), args.set)
    torch.manual_seed(0)  # keys the checkpoint lacks stay at a reproducible init
    model = build_model(cfg.model, device="cpu")
    state = load_pretrained(args.checkpoint, cfg.model, kind=args.kind)
    _, report = merge_pretrained(model, state, return_report=True)
    out.mkdir(parents=True)
    torch.save({"model": model.state_dict()}, out / STATE_FILE)
    print(f"wrote {out} ({len(model.state_dict())} tensors; missing={len(report['missing'])} "
          f"unexpected={len(report['unexpected'])} mismatched={len(report['mismatched'])})")
    if report["mismatched"]:
        raise SystemExit("shape mismatches found: wrong config?")
    return out


if __name__ == "__main__":
    main()
