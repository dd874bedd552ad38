"""Model construction from configs, in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/builder.py:build_model``:
UperNet with its FCN auxiliary head, SemanticFPN, and the classifier
(``ClsHead`` on the backbone's last feature). The heads take the JAX
builder's defaults (``builder.py:32-87`` there).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..configs.schema import BackboneConfig, HeadConfig, ModelConfig
from ..utils.device import resolve_device
from .dat import DAT
from .heads import ClsHead, FCNHead, FPNHead, FPNNeck, UPerHead
from .segmentor import DatClassifier, EncoderDecoder


def build_backbone(cfg: BackboneConfig) -> DAT:
    """DAT from every field of ``BackboneConfig`` (``kernel_impl`` and
    ``use_checkpoint`` among them); a field DAT does not take raises."""
    return DAT(**{f: getattr(cfg, f) for f in BackboneConfig.__dataclass_fields__})


def build_head(cfg: HeadConfig, in_channels, align_corners: bool = False) -> torch.nn.Module:
    """A decode or auxiliary head from its config; ``in_channels`` is a
    list for the multi-level heads and an int for ``FCNHead``."""
    kw = cfg.kwargs
    if cfg.type == "UPerHead":
        return UPerHead(
            in_channels, cfg.num_classes, cfg.channels,
            pool_scales=tuple(kw.get("pool_scales", (1, 2, 3, 6))),
            dropout_ratio=kw.get("dropout_ratio", 0.1),
            topdown=kw.get("topdown", "mmseg"),
        )
    if cfg.type == "FCNHead":
        return FCNHead(
            in_channels, cfg.num_classes, cfg.channels,
            num_convs=kw.get("num_convs", 1),
            dropout_ratio=kw.get("dropout_ratio", 0.1),
        )
    if cfg.type == "FPNHead":
        return FPNHead(
            in_channels, cfg.num_classes,
            feature_strides=tuple(kw.get("feature_strides", (4, 8, 16, 32))),
            channels=cfg.channels,
            dropout_ratio=kw.get("dropout_ratio", 0.1),
            align_corners=align_corners,
        )
    raise ValueError(f"unknown head type {cfg.type!r}")


def build_model(
    cfg: ModelConfig, *, device: Optional[Union[str, torch.device]] = None
) -> Union[EncoderDecoder, DatClassifier]:
    """ModelConfig -> ``EncoderDecoder`` (UperNet + FCN auxiliary head, or
    SemanticFPN) or ``DatClassifier`` (a ``ClsHead`` config) in eval mode on
    ``device`` (``cuda`` unless the caller names another).

    Weights are PyTorch's default initialisation from the global RNG
    (seed it with ``torch.manual_seed``); made on the CPU, then moved.
    """
    device = resolve_device(device)
    dims = cfg.backbone.dims
    backbone = build_backbone(cfg.backbone)
    if cfg.decode_head.type == "ClsHead":
        head = ClsHead(dims[-1], cfg.decode_head.num_classes,
                       cfg.decode_head.kwargs.get("dropout_ratio", 0.0))
        return DatClassifier(backbone, head).to(device).eval()
    neck = FPNNeck(dims, cfg.neck.out_channels) if cfg.neck is not None else None
    head_in = [cfg.neck.out_channels] * len(dims) if neck is not None else list(dims)
    if cfg.decode_head.type == "FPNHead":
        head_in = head_in[0]
    decode = build_head(cfg.decode_head, head_in, cfg.align_corners)
    aux = None
    if cfg.auxiliary_head is not None:
        aux = build_head(cfg.auxiliary_head, dims[cfg.aux_in_index], cfg.align_corners)
    model = EncoderDecoder(
        backbone, decode, neck, align_corners=cfg.align_corners,
        auxiliary_head=aux, aux_in_index=cfg.aux_in_index,
    )
    return model.to(device).eval()
