"""Model construction from configs, in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/builder.py``: the head
registry (``register_head``; ``HeadConfig.type`` selects a head), and
``build_model`` / ``build_model_from_config``, which assemble UperNet with
its FCN auxiliary head, SemanticFPN, or the classifier (``ClsHead`` on the
backbone's last feature). The heads take the JAX builder's defaults
(``builder.py:32-87`` there).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from ..configs.schema import BackboneConfig, HeadConfig, ModelConfig, TrainConfig
from ..utils.device import resolve_device
from .dat import DAT
from .heads import ClsHead, FCNHead, FPNHead, FPNNeck, UPerHead
from .segmentor import DatClassifier, EncoderDecoder


def build_backbone(cfg: BackboneConfig) -> DAT:
    """DAT from every field of ``BackboneConfig`` (``kernel_impl`` and
    ``use_checkpoint`` among them); a field DAT does not take raises."""
    return DAT(**{f: getattr(cfg, f) for f in BackboneConfig.__dataclass_fields__})


_HEAD_REGISTRY: Dict[str, Callable[..., torch.nn.Module]] = {}


def register_head(name: str):
    """Register a head builder ``fn(cfg: HeadConfig, in_channels,
    align_corners) -> nn.Module`` under ``name``, the ``HeadConfig.type``
    that selects it (the JAX package's registry, ``builder.py:19-30``
    there, with the port's extra arguments: its heads are built with their
    input widths)."""

    def deco(fn):
        _HEAD_REGISTRY[name] = fn
        return fn

    return deco


@register_head("UPerHead")
def _build_uper(cfg: HeadConfig, in_channels, align_corners: bool = False) -> torch.nn.Module:
    kw = cfg.kwargs
    return UPerHead(
        in_channels, cfg.num_classes, cfg.channels,
        pool_scales=tuple(kw.get("pool_scales", (1, 2, 3, 6))),
        dropout_ratio=kw.get("dropout_ratio", 0.1),
        topdown=kw.get("topdown", "mmseg"),
    )


@register_head("FCNHead")
def _build_fcn(cfg: HeadConfig, in_channels, align_corners: bool = False) -> torch.nn.Module:
    kw = cfg.kwargs
    return FCNHead(
        in_channels, cfg.num_classes, cfg.channels,
        num_convs=kw.get("num_convs", 1),
        dropout_ratio=kw.get("dropout_ratio", 0.1),
    )


@register_head("FPNHead")
def _build_fpn(cfg: HeadConfig, in_channels, align_corners: bool = False) -> torch.nn.Module:
    kw = cfg.kwargs
    return FPNHead(
        in_channels, cfg.num_classes,
        feature_strides=tuple(kw.get("feature_strides", (4, 8, 16, 32))),
        channels=cfg.channels,
        dropout_ratio=kw.get("dropout_ratio", 0.1),
        align_corners=align_corners,
    )


@register_head("ClsHead")
def _build_cls(cfg: HeadConfig, in_channels, align_corners: bool = False) -> torch.nn.Module:
    return ClsHead(in_channels, cfg.num_classes, cfg.kwargs.get("dropout_ratio", 0.0))


def build_head(cfg: HeadConfig, in_channels, align_corners: bool = False) -> torch.nn.Module:
    """A head from its config through the registry; ``in_channels`` is a
    list for the multi-level heads and an int for ``FCNHead`` and
    ``ClsHead``."""
    if cfg.type not in _HEAD_REGISTRY:
        raise ValueError(f"unknown head type {cfg.type!r}; registered: {sorted(_HEAD_REGISTRY)}")
    return _HEAD_REGISTRY[cfg.type](cfg, in_channels, align_corners)


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
        head = build_head(cfg.decode_head, dims[-1])
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


def build_model_from_config(
    name_or_cfg: Union[str, TrainConfig, ModelConfig], *,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[EncoderDecoder, DatClassifier]:
    """``build_model`` from a preset name, a ``TrainConfig`` or a
    ``ModelConfig`` (the JAX package's ``build_model_from_config``)."""
    from ..configs.presets import get_config

    cfg = get_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
    if hasattr(cfg, "model"):
        cfg = cfg.model
    return build_model(cfg, device=device)
