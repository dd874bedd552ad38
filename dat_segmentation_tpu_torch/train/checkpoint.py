"""Loading the reference's pretrained weights into a port model.

The port's counterpart of ``load_pretrained`` and ``merge_pretrained``
(``dat_segmentation_tpu/train/checkpoint.py:121-191``). A reference
``.pth`` is translated by ``utils/torch_convert.py``; the JAX package's
orbax directories need JAX to read and are refused. The trainer's
``CheckpointManager`` comes with the seg trainer (ROADMAP.md, Queue 1
item 3).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import torch

from ..utils import torch_convert as tc


def load_pretrained(path: str, model_cfg, kind: str = "segmentor") -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> a state_dict in the port's keys for the
    segmentor of ``model_cfg``: the whole EncoderDecoder (``kind``
    ``'segmentor'``), or its backbone alone from a backbone checkpoint
    (``'backbone'``: keys at the top level, returned under
    ``backbone.``)."""
    p = Path(path)
    if p.is_dir():
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
