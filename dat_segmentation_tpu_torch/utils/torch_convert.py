"""The reference's PyTorch checkpoints onto the port's ``state_dict``.

The port's own copy of ``dat_segmentation_tpu/utils/torch_convert.py``.
The JAX package translates a reference state_dict into a flax tree; the
port's modules carry the JAX module names and already use PyTorch's
layouts (OIHW convolutions, ``nn.Linear``), so here most entries are a
rename. The one change of layout: a 1x1 convolution of the reference,
(out, in, 1, 1), that the port keeps as an ``nn.Linear``, (out, in).

The translation is one table of ``(reference key, port key, layout)``
entries, built from the model config (``segmentor_table``,
``classifier_table``, ``backbone_table`` and one function a head), so that
its inverse
(``tools/reference_schema.py``) falls out of it. Both key schemas of
the heads: the reference's standalone modules (``models/heads/*``) and
mmseg's published checkpoints (``psp_modules`` / ``bottleneck`` /
``conv_seg``); which one a head uses is read from the checkpoint's keys.

mmseg's ``FPNHead`` interleaves an ``Upsample`` after each ConvModule of
a level that upsamples, so the k-th conv of such a level is
``scale_heads.{i}.{2k}``; the JAX package's converter reads
``scale_heads.{i}.{k}`` (``convert_fpn_head`` there), which names
another module or none from the third level on (ROADMAP.md, Queue 3).

Loading mirrors the reference's tolerant loader: unwrap ``state_dict`` /
``model_state`` / ``model``, strip ``module.``, and report missing,
unexpected and shape-mismatched keys (``train/checkpoint.py``) instead
of failing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

SAME = "same"  # the tensor as it is
CONV1X1 = "conv1x1"  # reference (out, in, 1, 1) conv (or (out, in) linear) -> port nn.Linear
COUNT = "count"  # BatchNorm's num_batches_tracked: 0 where the checkpoint has none

Entry = Tuple[str, str, str]  # (reference key, port key, layout)

# a key only mmseg's head of that type has (the JAX converter's test)
UPER_MMSEG_KEY = "psp_modules.0.1.conv.weight"
FCN_MMSEG_KEY = "convs.0.conv.weight"


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """torch.load a checkpoint file -> flat {key: tensor on the CPU}.
    Unwraps ``state_dict`` / ``model_state`` / ``model`` and strips
    ``module.`` prefixes (reference loading.py:17-20); floating tensors
    become float32. Loads with ``weights_only=True``: tensors and plain
    containers only, no code is unpickled."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model_state", "model"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    out = {}
    for k, v in ckpt.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[k] = v.float() if v.is_floating_point() else v
    return out


# ---------------------------------------------------------------------------
# table pieces
# ---------------------------------------------------------------------------


def _conv(ref: str, port: str, *, bias: bool = True, layout: str = SAME) -> List[Entry]:
    out = [(f"{ref}.weight", f"{port}.weight", layout)]
    if bias:
        out.append((f"{ref}.bias", f"{port}.bias", SAME))
    return out


def _ln(ref: str, port: str) -> List[Entry]:
    return [(f"{ref}.weight", f"{port}.weight", SAME), (f"{ref}.bias", f"{port}.bias", SAME)]


def _bn(ref: str, port: str) -> List[Entry]:
    return [(f"{ref}.{n}", f"{port}.{n}", SAME)
            for n in ("weight", "bias", "running_mean", "running_var")] + [
        (f"{ref}.num_batches_tracked", f"{port}.num_batches_tracked", COUNT)]


def _cbr(conv: str, bn: str, port: str) -> List[Entry]:
    """ConvBNReLU: a bias-free conv and a BatchNorm."""
    return _conv(conv, f"{port}.conv", bias=False) + _bn(bn, f"{port}.bn")


def backbone_table(cfg, ref: str = "", port: str = "") -> List[Entry]:
    """The DAT backbone (reference dat.py) from ``BackboneConfig``; keys
    under ``ref`` in the checkpoint and ``port`` in the port."""
    t: List[Entry] = []
    t += _conv(f"{ref}patch_proj.0", f"{port}stem_conv1")
    t += _ln(f"{ref}patch_proj.1.norm", f"{port}stem_ln1")
    if cfg.use_conv_patches:
        t += _conv(f"{ref}patch_proj.3", f"{port}stem_conv2")
        t += _ln(f"{ref}patch_proj.4.norm", f"{port}stem_ln2")
    for i in range(4):
        sr, sp = f"{ref}stages.{i}.", f"{port}stage_{i}."
        in_dim = cfg.dim_stem if i == 0 else cfg.dims[i]
        if in_dim != cfg.dims[i]:
            t += _conv(f"{sr}proj", f"{sp}proj")
        for d in range(cfg.depths[i]):
            if cfg.use_lpus[i]:
                t += _conv(f"{sr}local_perception_units.{d}", f"{sp}lpu_{d}")
            mr, mp = f"{sr}mlps.{d}.", f"{sp}mlp_{d}."
            if cfg.use_dwc_mlps[i]:
                t += _conv(f"{mr}linear1.0", f"{mp}fc1", layout=CONV1X1)
                t += _conv(f"{mr}dwc", f"{mp}dwc")
                t += _conv(f"{mr}linear2.0", f"{mp}fc2", layout=CONV1X1)
                if cfg.use_cmt_mlps[i]:
                    t += _bn(f"{mr}linear1.2", f"{mp}bn1")
                    t += _bn(f"{mr}bn", f"{mp}bn2")
                    t += _bn(f"{mr}linear2.1", f"{mp}bn3")
            else:  # nn.Linear in the reference too
                t += _conv(f"{mr}chunk.linear1", f"{mp}fc1")
                t += _conv(f"{mr}chunk.linear2", f"{mp}fc2")
            spec = cfg.stage_spec[i][d]
            if spec == "X":
                t += _conv(f"{sr}attns.{d}", f"{sp}conv_attn_{d}")
                t += _ln(f"{sr}ln_cnvnxt.{d}.norm", f"{sp}ln_cnvnxt_{d}")
            elif spec == "D":
                t += _ln(f"{sr}layer_norms.{2 * d}.norm", f"{sp}norm1_{d}")
                t += _ln(f"{sr}layer_norms.{2 * d + 1}.norm", f"{sp}norm2_{d}")
                ar, ap = f"{sr}attns.{d}.", f"{sp}attn_{d}."
                for name in ("proj_q", "proj_k", "proj_v", "proj_out"):
                    t += _conv(f"{ar}{name}", f"{ap}{name}", layout=CONV1X1)
                t += _conv(f"{ar}conv_offset.0", f"{ap}offset_dwc")
                t += _ln(f"{ar}conv_offset.1.norm", f"{ap}offset_ln")
                t += _conv(f"{ar}conv_offset.3", f"{ap}offset_proj", bias=False, layout=CONV1X1)
                if cfg.use_pes[i] and not cfg.no_offs[i]:  # the reference's rpe_table
                    if cfg.dwc_pes[i]:  # a 3x3 depthwise conv
                        t += _conv(f"{ar}rpe_table", f"{ap}rpe_dwc")
                    elif cfg.log_cpb[i]:  # Linear(2, 32), ReLU, Linear(32, h_g) without bias
                        t += _conv(f"{ar}rpe_table.0", f"{ap}cpb_fc1")
                        t += _conv(f"{ar}rpe_table.2", f"{ap}cpb_fc2", bias=False)
                    else:  # the continuous or the fixed_pe table
                        t.append((f"{ar}rpe_table", f"{ap}rpe_table", SAME))
                if cfg.layer_scale_values[i] > 0:
                    t.append((f"{sr}layer_scales.{2 * d}.gamma", f"{sp}ls1_{d}.gamma", SAME))
                    t.append((f"{sr}layer_scales.{2 * d + 1}.gamma", f"{sp}ls2_{d}.gamma", SAME))
        if i in cfg.out_indices:
            t += _ln(f"{ref}norms.{i}.norm", f"{port}out_norm_{i}")
        if i < 3:
            t += _conv(f"{ref}down_projs.{i}.0", f"{port}down_conv_{i}", bias=False)
            t += _ln(f"{ref}down_projs.{i}.1.norm", f"{port}down_ln_{i}")
    return t


def uper_head_table(ref: str, port: str, pool_scales: Sequence[int] = (1, 2, 3, 6),
                    n_in: int = 4, *, mmseg: bool) -> List[Entry]:
    """UPerHead, mmseg's names (``psp_modules`` / ``bottleneck`` /
    ``fpn_bottleneck`` / ``conv_seg``) or the standalone head's."""
    t: List[Entry] = []
    for j in range(len(pool_scales)):
        if mmseg:
            t += _cbr(f"{ref}psp_modules.{j}.1.conv", f"{ref}psp_modules.{j}.1.bn", f"{port}ppm_{j}")
        else:
            t += _cbr(f"{ref}ppm_modules.{j}.1", f"{ref}ppm_modules.{j}.2", f"{port}ppm_{j}")
    if mmseg:
        t += _cbr(f"{ref}bottleneck.conv", f"{ref}bottleneck.bn", f"{port}ppm_bottleneck")
    else:
        t += _cbr(f"{ref}ppm_bottleneck.0", f"{ref}ppm_bottleneck.1", f"{port}ppm_bottleneck")
    for i in range(n_in - 1):
        for name in ("lateral", "fpn"):
            if mmseg:
                t += _cbr(f"{ref}{name}_convs.{i}.conv", f"{ref}{name}_convs.{i}.bn",
                          f"{port}{name}_{i}")
            else:
                t += _cbr(f"{ref}{name}_convs.{i}.0", f"{ref}{name}_convs.{i}.1",
                          f"{port}{name}_{i}")
    if mmseg:
        t += _cbr(f"{ref}fpn_bottleneck.conv", f"{ref}fpn_bottleneck.bn", f"{port}fuse_bottleneck")
        t += _conv(f"{ref}conv_seg", f"{port}cls_seg", layout=CONV1X1)
    else:
        t += _cbr(f"{ref}fuse_bottleneck.0", f"{ref}fuse_bottleneck.1", f"{port}fuse_bottleneck")
        t += _conv(f"{ref}cls_seg", f"{port}cls_seg", layout=CONV1X1)
    return t


def fcn_head_table(ref: str, port: str, num_convs: int = 1, *, mmseg: bool) -> List[Entry]:
    """FCNHead: mmseg's ``convs.{i}.conv`` / ``conv_seg``, or the
    standalone Sequential's ``convs.{3i}`` / ``cls_seg``."""
    t: List[Entry] = []
    for i in range(num_convs):
        if mmseg:
            t += _cbr(f"{ref}convs.{i}.conv", f"{ref}convs.{i}.bn", f"{port}conv_{i}")
        else:
            t += _cbr(f"{ref}convs.{3 * i}", f"{ref}convs.{3 * i + 1}", f"{port}conv_{i}")
    return t + _conv(f"{ref}{'conv_seg' if mmseg else 'cls_seg'}", f"{port}cls_seg",
                     layout=CONV1X1)


def fpn_neck_table(ref: str, port: str, n_in: int = 4) -> List[Entry]:
    """mmseg's FPN neck: ``lateral_convs.{i}.conv`` (1x1), ``fpn_convs.{i}.conv``."""
    t: List[Entry] = []
    for i in range(n_in):
        t += _conv(f"{ref}lateral_convs.{i}.conv", f"{port}lateral_{i}", layout=CONV1X1)
        t += _conv(f"{ref}fpn_convs.{i}.conv", f"{port}fpn_{i}")
    return t


def fpn_head_table(ref: str, port: str,
                   feature_strides: Sequence[int] = (4, 8, 16, 32)) -> List[Entry]:
    """mmseg's FPNHead: ``scale_heads.{i}`` is a Sequential of ConvModules,
    each followed by an ``Upsample`` (no parameters) on a level that
    upsamples, so its k-th conv sits at position 2k there."""
    t: List[Entry] = []
    for i, fs in enumerate(feature_strides):
        length = max(1, int(math.log2(fs) - math.log2(feature_strides[0])))
        step = 1 if fs == feature_strides[0] else 2
        for k in range(length):
            t += _cbr(f"{ref}scale_heads.{i}.{step * k}.conv", f"{ref}scale_heads.{i}.{step * k}.bn",
                      f"{port}scale_{i}_{k}")
    return t + _conv(f"{ref}conv_seg", f"{port}cls_seg", layout=CONV1X1)


def cls_head_table(ref: str, port: str) -> List[Entry]:
    """The classifier head: ``norm.norm`` (a LayerNormProxy) and ``fc``."""
    return _ln(f"{ref}norm.norm", f"{port}norm") + _conv(f"{ref}fc", f"{port}fc")


def classifier_table(model_cfg) -> List[Entry]:
    """The whole DatClassifier: ``backbone.*`` and ``head.*``."""
    return (backbone_table(model_cfg.backbone, "backbone.", "backbone.")
            + cls_head_table("head.", "head."))


def _is_mmseg(sd: Optional[Mapping], key: str, default: bool) -> bool:
    return default if sd is None else key in sd


def segmentor_table(model_cfg, sd: Optional[Mapping] = None, *, mmseg: bool = True) -> List[Entry]:
    """The whole EncoderDecoder. Each UperNet or FCN head takes mmseg's
    names or the standalone ones as ``sd``'s keys show (the JAX
    converter's rule), or as ``mmseg`` says when no ``sd`` is given."""
    t = backbone_table(model_cfg.backbone, "backbone.", "backbone.")
    n_in = len(model_cfg.backbone.out_indices)
    head = model_cfg.decode_head
    kw = head.kwargs
    if head.type == "UPerHead":
        t += uper_head_table(
            "decode_head.", "decode_head.", tuple(kw.get("pool_scales", (1, 2, 3, 6))), n_in,
            mmseg=_is_mmseg(sd, "decode_head." + UPER_MMSEG_KEY, mmseg))
    elif head.type == "FPNHead":
        t += fpn_head_table("decode_head.", "decode_head.",
                            tuple(kw.get("feature_strides", (4, 8, 16, 32))))
    elif head.type == "FCNHead":
        t += fcn_head_table("decode_head.", "decode_head.", kw.get("num_convs", 1),
                            mmseg=_is_mmseg(sd, "decode_head." + FCN_MMSEG_KEY, mmseg))
    else:
        raise KeyError(head.type)
    if model_cfg.auxiliary_head is not None:
        t += fcn_head_table(
            "auxiliary_head.", "auxiliary_head.",
            model_cfg.auxiliary_head.kwargs.get("num_convs", 1),
            mmseg=_is_mmseg(sd, "auxiliary_head." + FCN_MMSEG_KEY, mmseg))
    if model_cfg.neck is not None:
        t += fpn_neck_table("neck.", "neck.", n_in)
    return t


# ---------------------------------------------------------------------------
# applying a table
# ---------------------------------------------------------------------------


def apply_table(sd: Mapping[str, torch.Tensor], table: Sequence[Entry]) -> Dict[str, torch.Tensor]:
    """Reference state_dict -> port state_dict through ``table``. A
    reference key the table needs and ``sd`` lacks raises KeyError, as the
    JAX converter does; keys the table does not name are left out."""
    out: Dict[str, torch.Tensor] = {}
    for ref, port, layout in table:
        if layout == COUNT:
            out[port] = sd.get(ref, torch.tensor(0)).to(torch.long)
            continue
        if ref not in sd:
            raise KeyError(f"reference checkpoint lacks {ref} (for the port's {port})")
        v = sd[ref]
        out[port] = v.reshape(v.shape[0], -1) if layout == CONV1X1 else v
    return out


def convert_backbone(sd: Mapping[str, torch.Tensor], backbone_cfg, prefix: str = "",
                     port_prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference DAT backbone's keys under ``prefix`` -> the port's
    ``DAT`` keys under ``port_prefix``."""
    return apply_table(sd, backbone_table(backbone_cfg, prefix, port_prefix))


def convert_uper_head(sd, prefix: str, pool_scales=(1, 2, 3, 6), n_in: int = 4):
    """Reference UPerHead (either schema) -> the port's ``UPerHead`` keys."""
    return apply_table(sd, uper_head_table(prefix, "", pool_scales, n_in,
                                           mmseg=prefix + UPER_MMSEG_KEY in sd))


def convert_fcn_head(sd, prefix: str, num_convs: int = 1):
    """Reference FCNHead (either schema) -> the port's ``FCNHead`` keys."""
    return apply_table(sd, fcn_head_table(prefix, "", num_convs,
                                          mmseg=prefix + FCN_MMSEG_KEY in sd))


def convert_fpn_neck(sd, prefix: str, n_in: int = 4):
    """mmseg FPN neck -> the port's ``FPNNeck`` keys."""
    return apply_table(sd, fpn_neck_table(prefix, "", n_in))


def convert_fpn_head(sd, prefix: str, feature_strides=(4, 8, 16, 32)):
    """mmseg FPNHead -> the port's ``FPNHead`` keys."""
    return apply_table(sd, fpn_head_table(prefix, "", feature_strides))


def convert_segmentor(sd: Mapping[str, torch.Tensor], model_cfg) -> Dict[str, torch.Tensor]:
    """EncoderDecoder state_dict (either head schema) -> the port's
    ``EncoderDecoder`` state_dict."""
    return apply_table(sd, segmentor_table(model_cfg, sd))


def convert_cls_head(sd, prefix: str):
    """Reference ClsHead -> the port's ``ClsHead`` keys."""
    return apply_table(sd, cls_head_table(prefix, ""))


def convert_classifier(sd: Mapping[str, torch.Tensor], model_cfg) -> Dict[str, torch.Tensor]:
    """DatClassifier state_dict -> the port's ``DatClassifier`` state_dict."""
    return apply_table(sd, classifier_table(model_cfg))


def report_diff(want: Mapping[str, tuple], have: Mapping[str, tuple]) -> Tuple[list, list]:
    """Missing and unexpected keys between the model's key -> shape map
    and a converted one (the tolerant-load report, reference
    loading.py:29-35)."""
    return sorted(set(want) - set(have)), sorted(set(have) - set(want))
