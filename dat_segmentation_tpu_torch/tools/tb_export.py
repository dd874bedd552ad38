"""Turn a ``*.scalars.jsonl`` of ``utils/logging.py:MetricLogger`` into
TensorBoard event files.

    python -m dat_segmentation_tpu_torch.tools.tb_export \\
        work_dirs/upn_tiny_160k_dp03_lr6/train.scalars.jsonl [--out DIR]

The port's ``tools/tb_export.py`` (the JAX package's, with its arguments).
The trainers already write events beside the JSONL (``<run dir>/tb``);
this rebuilds them from the JSONL alone, for ``tensorboard --logdir``.
Each line is one event at its ``step``: blank lines are skipped, and so
are ``time`` and every value that is not a number. ``--out`` defaults to
``<run dir>/tb``. Writes through ``utils/tensorboard.py:SummaryWriter``;
``main(argv)`` returns the event directory.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

from ..utils.tensorboard import SummaryWriter


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="scalars JSONL -> TensorBoard events")
    p.add_argument("scalars", help="path to *.scalars.jsonl")
    p.add_argument("--out", default=None, help="TensorBoard logdir (default: <run dir>/tb)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    args = parse_args(argv)
    src = Path(args.scalars)
    out = Path(args.out) if args.out else src.parent / "tb"
    writer = SummaryWriter(out)
    n = 0
    for line in src.read_text().splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        step = int(rec.pop("step", 0))
        rec.pop("time", None)
        values = {k: v for k, v in rec.items() if isinstance(v, (int, float))}
        if values:
            writer.add_scalars_dict(values, step)
            n += 1
    writer.close()
    print(f"wrote {n} events to {out}")
    return out


if __name__ == "__main__":
    main()
