"""Logging: timestamped metric lines, a scalar sidecar, TensorBoard events
and per-parameter weight statistics.

Counterpart of ``dat_segmentation_tpu/utils/logging.py``. ``MetricLogger``
writes each line to stdout and its file with a timestamp, each scalar
record to ``<log>.scalars.jsonl`` and to TensorBoard event files under
``<log dir>/tb`` (``utils/tensorboard.py``, no TensorBoard dependency).
Only the main process logs: rank 0 of ``torch.distributed``, or the only
process when it is not initialised. ``weight_stats`` is the per-parameter
mean, std and L2 norm (reference train_backbone.py:73-83);
``weight_stats_on_device`` the same from one reduction on the parameters'
device and one copy of its (n, 3) table to the host (the classifier
trainer's stats interval); ``grad_update_ratio`` is ||update|| / ||param||
(train_backbone.py:131-135) on the host. No trainer calls it: the train
step returns the same ratio from the device; it stays as the JAX
package's public counterpart.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist


def is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricLogger:
    """Timestamped log lines to stdout + file, scalar JSONL sidecar."""

    def __init__(self, path: Optional[Union[str, Path]] = None, *, quiet: bool = False):
        self.path = Path(path) if path else None
        self.quiet = quiet
        self._tb = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.scalars_path = self.path.with_suffix(".scalars.jsonl")
            if is_main_process():
                from .tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.path.parent / "tb")
        else:
            self.scalars_path = None

    def log(self, msg: str):
        if not is_main_process():
            return
        line = f"{time.strftime('%Y-%m-%d %H:%M:%S')} {msg}"
        if not self.quiet:
            print(line, flush=True)
        if self.path:
            with self.path.open("a") as f:
                f.write(line + "\n")

    def scalars(self, step: int, **values):
        if not is_main_process() or not self.scalars_path:
            return
        vals = {k: float(v) for k, v in values.items()}
        rec = {"step": step, "time": time.time()}
        rec.update(vals)
        with self.scalars_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalars_dict(vals, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def weight_stats(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                 prefix: str = "") -> dict:
    """{name: {'mean', 'std', 'l2'}} of every parameter (a module's named
    parameters, or a name -> tensor mapping), in float64 on the host. The
    std is the population one (numpy's, as the JAX package takes it)."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    out = {}
    for name, t in items:
        a = t.detach().to("cpu", torch.float64)
        out[prefix + name] = {
            "mean": float(a.mean()),
            "std": float(a.std(correction=0)),
            "l2": float(torch.linalg.vector_norm(a)),
        }
    return out


def _named(params) -> list:
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    return list(items)


def weight_stats_on_device(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                           prefix: str = "") -> dict:
    """``weight_stats`` computed where the parameters are: an (n, 3) float32
    table of mean, population std and L2 norm, then one copy to the host."""
    items = _named(params)
    with torch.no_grad():
        rows = []
        for _, t in items:
            x = t.detach().float()
            rows.append(torch.stack([x.mean(), x.std(correction=0), torch.linalg.vector_norm(x)]))
        table = torch.stack(rows).cpu().numpy() if rows else []
    return {prefix + name: {"mean": float(r[0]), "std": float(r[1]), "l2": float(r[2])}
            for (name, _), r in zip(items, table)}


def grad_update_ratio(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                      updates: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> float:
    """||update|| / ||param|| over all tensors, in float64 on the host."""
    def norm(tree):
        return float(np.sqrt(sum(float(torch.sum(t.detach().double() ** 2))
                                 for _, t in _named(tree))))

    return norm(updates) / max(norm(params), 1e-12)
