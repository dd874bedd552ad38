"""Test scaffolding: write a port model's weights as a reference checkpoint.

No trained DAT/DAT++ weights are in the repository, so the tests and
``chip_smoke.py`` make a checkpoint in the reference's key schema from a
port model: the inverse of ``utils/torch_convert.py``'s table (each entry
read backwards; a 1x1 convolution the port keeps as an ``nn.Linear`` goes
back to (out, in, 1, 1)). Loading the file through ``load_pretrained``
must give the model's tensors back. Nothing in the port's entry points
uses this module.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Union

import torch

from ..utils.torch_convert import CONV1X1, classifier_table, segmentor_table


def to_reference(state_dict: Mapping[str, torch.Tensor], model_cfg, *,
                 mmseg: bool = True) -> Dict[str, torch.Tensor]:
    """The port's EncoderDecoder ``state_dict`` (mmseg's head names, or the
    standalone heads' with ``mmseg=False``) or DatClassifier ``state_dict``
    (a ``ClsHead`` config) -> the reference's keys, float32 tensors on the
    CPU."""
    if model_cfg.decode_head.type == "ClsHead":
        table = classifier_table(model_cfg)
    else:
        table = segmentor_table(model_cfg, mmseg=mmseg)
    out = {}
    for ref, port, layout in table:
        v = state_dict[port].detach().cpu()
        v = v.float() if v.is_floating_point() else v
        out[ref] = v[:, :, None, None].clone() if layout == CONV1X1 else v.clone()
    return out


def save_reference(model: torch.nn.Module, model_cfg, path: Union[str, Path], *,
                   mmseg: bool = True) -> Path:
    """Write ``{'state_dict': to_reference(model.state_dict())}`` to
    ``path``, as mmcv's ``save_checkpoint`` nests it."""
    path = Path(path)
    torch.save({"state_dict": to_reference(model.state_dict(), model_cfg, mmseg=mmseg)}, path)
    return path
