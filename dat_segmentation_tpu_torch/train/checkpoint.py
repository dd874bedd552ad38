"""Checkpoints of the port: the trainer's ``CheckpointManager``, the
backbone-only export, and loading pretrained weights into a port model.

The port's counterpart of ``dat_segmentation_tpu/train/checkpoint.py``, on
``torch.save`` instead of orbax, with the JAX layout and names: a
``ckpt_{tag}`` directory for ``tag`` a step or ``"best"``, holding
``state.pt``, and ``ckpt_{tag}.meta.json`` beside it. ``max_to_keep``
collects the oldest step directories and never ``best``. A step
checkpoint holds the model's ``state_dict`` (parameters and BatchNorm
buffers), the AdamW ``state_dict``, the step and the drop-path/dropout
generator's ``get_state()``; ``best`` holds the model's ``state_dict``
only, as the JAX package's holds params and batch_stats.

Inside a ``torch.distributed`` process group rank 0 writes and every rank
waits for it (``save``); every rank reads. The trainers gather a sharded
(fsdp) model's state to the one-process format first
(``parallel/mesh.py:full_state``), so a checkpoint written by W processes
resumes in one, and the reverse.

``load_pretrained`` reads a reference ``.pth`` (translated by
``utils/torch_convert.py``) or a ``ckpt_*`` directory written here; the
JAX package's orbax directories need JAX to read and are refused.
``merge_pretrained`` is ``:155-191`` there.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

from ..parallel import mesh
from ..utils import torch_convert as tc

STATE_FILE = "state.pt"


class CheckpointManager:
    """``ckpt_{tag}/state.pt`` under ``directory``, with metadata beside
    it and the ``max_to_keep`` newest step directories kept."""

    def __init__(self, directory: Union[str, Path], *, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _step_dir(self, tag) -> Path:
        return self.directory / f"ckpt_{tag}"

    def save(self, tag, state: Dict[str, Any], *, metadata: Optional[dict] = None,
             overwrite: bool = True) -> Path:
        """Write ``state`` (anything ``torch.save`` takes: tensors on any
        device, state_dicts, numbers) as ``ckpt_{tag}``; then the metadata
        and the collection of old steps. In a process group rank 0 writes
        and every rank returns once it has."""
        path = self._step_dir(tag)
        if mesh.is_distributed():
            if mesh.is_main():
                self._write(path, state, metadata, overwrite)
            mesh.barrier()
            return path
        return self._write(path, state, metadata, overwrite)

    def _write(self, path: Path, state, metadata, overwrite: bool) -> Path:
        tag = path.name[len("ckpt_"):]
        if path.exists():
            if not overwrite:
                raise FileExistsError(path)
            shutil.rmtree(path)
        tmp = path.with_name(path.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / STATE_FILE)
        tmp.rename(path)  # a directory is whole or absent
        if metadata is not None:
            (self.directory / f"ckpt_{tag}.meta.json").write_text(json.dumps(metadata, default=str))
        self._gc()
        return path

    def restore(self, tag, *, map_location=None) -> Dict[str, Any]:
        """The state saved as ``ckpt_{tag}``, its tensors on
        ``map_location`` (default: where they were)."""
        return torch.load(self._step_dir(tag) / STATE_FILE, map_location=map_location,
                          weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.directory.glob("ckpt_*")
                 if p.is_dir() and p.name.split("_")[1].isdigit()]
        return max(steps) if steps else None

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1]) for p in self.directory.glob("ckpt_*")
                       if p.is_dir() and p.name.split("_")[1].isdigit())
        for s in steps[: -self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            meta = self.directory / f"ckpt_{s}.meta.json"
            if meta.exists():
                meta.unlink()


def save_backbone_only(path: Union[str, Path], state_dict: Mapping[str, torch.Tensor]) -> Path:
    """Export the ``backbone.`` entries of a segmentor's ``state_dict`` as a
    checkpoint directory ``path`` (for seg fine-tuning; reference
    train_backbone.py:303-331). ``load_pretrained(path, cfg)`` reads it."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save({"model": {k: v for k, v in state_dict.items() if k.startswith("backbone.")}},
               path / STATE_FILE)
    return path


def load_pretrained(path: str, model_cfg, kind: str = "segmentor") -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> a state_dict in the port's keys for the
    segmentor of ``model_cfg``: the whole EncoderDecoder (``kind``
    ``'segmentor'``), or its backbone alone from a backbone checkpoint
    (``'backbone'``: keys at the top level, returned under
    ``backbone.``). A ``ckpt_*`` directory of ``CheckpointManager`` (or of
    ``save_backbone_only``) gives its model's ``state_dict`` as saved, on
    the CPU."""
    p = Path(path)
    if p.is_dir():
        if (p / STATE_FILE).exists():
            return torch.load(p / STATE_FILE, map_location="cpu", weights_only=True)["model"]
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package): reading it needs "
            "JAX, which the port does not import. The port loads the reference's .pth; "
            "tools/convert.py converts a .pth to orbax, not back."
        )
    sd = tc.load_torch_state_dict(str(p))
    if kind == "segmentor":
        return tc.convert_segmentor(sd, model_cfg)
    if kind == "backbone":
        return tc.convert_backbone(sd, model_cfg.backbone, port_prefix="backbone.")
    if kind == "classifier":
        return tc.convert_classifier(sd, model_cfg)
    raise ValueError(f"kind {kind!r}: 'segmentor', 'backbone' or 'classifier'")


def merge_pretrained(model: torch.nn.Module, state: Mapping[str, torch.Tensor], *,
                     verbose: bool = True, return_report: bool = False):
    """Tolerant merge of ``state`` into ``model``, in place: tensors whose
    key and shape match are copied (into the model's dtype and device);
    missing, unexpected and shape-mismatched keys are reported, and a
    mismatched one stays at its init value (silently "loading" a
    checkpoint of other dims would evaluate garbage). Returns the model,
    or ``(model, report)`` with ``return_report``."""
    own = model.state_dict()
    merged, mismatched = {}, []
    for k, v in state.items():
        if k in own:
            if tuple(own[k].shape) == tuple(v.shape):
                merged[k] = v
            else:
                mismatched.append((k, tuple(own[k].shape), tuple(v.shape)))
    missing, unexpected = tc.report_diff(
        {k: tuple(v.shape) for k, v in own.items()}, {k: tuple(v.shape) for k, v in state.items()})
    model.load_state_dict(merged, strict=False)
    if verbose and (missing or unexpected or mismatched):
        print(f"[load] missing keys: {len(missing)}")
        for k in missing[:10]:
            print("   ", k)
        print(f"[load] unexpected keys: {len(unexpected)}")
        for k in unexpected[:10]:
            print("   ", k)
        print(f"[load] shape-mismatched keys (kept at init): {len(mismatched)}")
        for k, want, got in mismatched[:10]:
            print(f"    {k}: init {want} vs checkpoint {got}")
    if return_report:
        return model, {"missing": missing, "unexpected": unexpected, "mismatched": mismatched}
    return model
