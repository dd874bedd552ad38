"""Ingest mmseg-style config dicts (reference configs/) into the port's schema.

A copy of ``dat_segmentation_tpu/configs/mmseg_compat.py`` over the port's
own ``schema.py``. The reference's model builder silently drops mmseg-only
kwargs via ``inspect.signature`` filtering (reference:
models/builder.py:125-150); this does the same explicitly, by mapping known
keys, so the reference's ``configs/dat/*.py`` model dicts (loaded as plain
python modules, ``_base_`` files merged) build the port's models.
"""

from __future__ import annotations

import importlib.util
from typing import Any, Dict, Optional

from .schema import BackboneConfig, HeadConfig, ModelConfig, NeckConfig

_BACKBONE_KEYS = set(BackboneConfig.__dataclass_fields__)

_SEQ_FIELDS = {
    f for f, spec in BackboneConfig.__dataclass_fields__.items()
    if "Tuple" in str(spec.type)
}


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(e) for e in v)
    return v


def backbone_config_from_mmseg(d: Dict[str, Any]) -> BackboneConfig:
    kwargs = {}
    for k, v in d.items():
        if k in _BACKBONE_KEYS:
            kwargs[k] = _tuplify(v) if k in _SEQ_FIELDS else v
        # mmseg-only keys (type, init_cfg, heads_q, sr_ratios, ...) dropped,
        # mirroring builder.py's signature filtering.
    return BackboneConfig(**kwargs)


def _head_from_mmseg(
    d: Optional[Dict[str, Any]],
    default_type: str = "UPerHead",
    default_channels: int = 512,
) -> Optional[HeadConfig]:
    if d is None:
        return None
    htype = d.get("type", default_type)
    kwargs = {}
    if htype == "UPerHead":
        kwargs["pool_scales"] = _tuplify(d.get("pool_scales", (1, 2, 3, 6)))
        kwargs["dropout_ratio"] = d.get("dropout_ratio", 0.1)
    elif htype == "FCNHead":
        kwargs["num_convs"] = d.get("num_convs", 1)
        kwargs["dropout_ratio"] = d.get("dropout_ratio", 0.1)
    elif htype == "FPNHead":
        kwargs["feature_strides"] = _tuplify(
            d.get("feature_strides", (4, 8, 16, 32))
        )
        kwargs["dropout_ratio"] = d.get("dropout_ratio", 0.1)
    return HeadConfig(
        type=htype,
        num_classes=d.get("num_classes", 150),
        channels=d.get("channels", default_channels),
        kwargs=kwargs,
    )


def model_config_from_mmseg(model: Dict[str, Any]) -> ModelConfig:
    """Build a ModelConfig from an mmseg ``model = dict(...)`` dict."""
    backbone = backbone_config_from_mmseg(model["backbone"])
    # role defaults match the reference _base_ files
    # (configs/_base_/models/upernet_dat.py:42-66)
    decode = _head_from_mmseg(model.get("decode_head"), "UPerHead", 512)
    aux = _head_from_mmseg(model.get("auxiliary_head"), "FCNHead", 256)
    neck = None
    if model.get("neck") is not None:
        neck = NeckConfig("FPN", model["neck"].get("out_channels", 256))
    aux_in_index = (
        model.get("auxiliary_head", {}) or {}
    ).get("in_index", 2)
    aux_w = 0.4
    if model.get("auxiliary_head"):
        aux_w = (
            model["auxiliary_head"].get("loss_decode", {}) or {}
        ).get("loss_weight", 0.4)
    test_cfg = model.get("test_cfg", {}) or {}
    return ModelConfig(
        backbone=backbone,
        decode_head=decode,
        auxiliary_head=aux,
        neck=neck,
        aux_in_index=aux_in_index,
        aux_loss_weight=aux_w,
        num_classes=decode.num_classes,
        test_mode=test_cfg.get("mode", "whole"),
    )


def _module_dict(path: str):
    """Exec a config module; return (public top-level names, _base_ list)
    (the reference's importlib loader semantics, models/builder.py:14-21)."""
    spec = importlib.util.spec_from_file_location("_user_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = {
        k: v for k, v in vars(mod).items()
        if not k.startswith("_") and not callable(v)
        and not isinstance(v, type(importlib))
    }
    return cfg, getattr(mod, "_base_", None)


def merge_config_dicts(base: Dict[str, Any], child: Dict[str, Any]) -> Dict[str, Any]:
    """mmcv Config merge semantics: dicts merge recursively; a child dict
    carrying ``_delete_=True`` replaces the base value wholesale
    (reference usage: configs/dat/upn_tiny_160k_dp03_lr6.py:43,50);
    non-dict values overwrite."""
    out = dict(base)
    for k, v in child.items():
        if (
            isinstance(v, dict)
            and isinstance(out.get(k), dict)
            and not v.get("_delete_", False)
        ):
            out[k] = merge_config_dicts(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != "_delete_"}
            out[k] = v
    return out


def load_mmseg_config(path: str) -> Dict[str, Any]:
    """Load an mmseg-style python config WITH ``_base_`` resolution.

    Reference configs are deltas over up to 4 base files
    (configs/dat/upn_tiny_160k_dp03_lr6.py:1-4: model / dataset / runtime /
    schedule); bases are resolved relative to the config file, merged in
    order (later bases overriding earlier on key conflicts, like mmcv),
    then the child module's own names are merged on top with ``_delete_``
    honored. Bases may themselves declare ``_base_`` (recursive).
    """
    import os

    cfg, bases = _module_dict(path)
    if not bases:
        return cfg
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for rel in bases:
        base_cfg = load_mmseg_config(
            os.path.normpath(os.path.join(os.path.dirname(path), rel))
        )
        merged = merge_config_dicts(merged, base_cfg)
    return merge_config_dicts(merged, cfg)


def load_python_config(path: str) -> Dict[str, Any]:
    """Load a python config (resolving ``_base_`` inheritance) and return
    its ``model`` dict."""
    cfg = load_mmseg_config(path)
    if "model" not in cfg:
        raise KeyError(
            f"config {path} defines no 'model' dict "
            f"(after _base_ resolution; keys: {sorted(cfg)})"
        )
    return cfg["model"]
