"""The port's reference-checkpoint loading against the JAX package's.

A reference-schema state dict is made from a port model by the inverse of
the port's table (``tools/reference_schema.py``), in mmseg's head names
and in the standalone heads' names. Two routes lead back: the port's
``convert_segmentor``, and the JAX ``convert_segmentor`` followed by the
port's ``convert_variables`` (JAX variables -> port). Both must give the
model's tensors exactly, with an empty ``report_diff``. The JAX route
reads the reference keys by its own names and layouts, independently of
the port's table, so it also holds the inverse to the reference schema.

One difference is deliberate: mmseg's FPNHead puts an ``Upsample`` after
each conv of an upsampling level, so its k-th conv there is
``scale_heads.{i}.{2k}``; the JAX converter reads ``scale_heads.{i}.{k}``
(ROADMAP.md, Queue 3). The JAX route is given those keys under its own
index; every other key is the same dict.
"""

import re

import numpy as np
import pytest
import torch

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.utils.torch_convert import convert_segmentor as jax_convert_segmentor
from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.tools.reference_schema import save_reference, to_reference
from dat_segmentation_tpu_torch.train.checkpoint import load_pretrained, merge_pretrained
from dat_segmentation_tpu_torch.utils import torch_convert as tc
from dat_segmentation_tpu_torch.utils.convert import convert_variables
from torch_port_helpers import small_fpn, small_upernet

CASES = [("upernet", True), ("upernet", False), ("fpn", True)]
MAKERS = {"upernet": small_upernet, "fpn": small_fpn}


def _model(kind, seed=0):
    torch.manual_seed(seed)
    model = build_model(MAKERS[kind](get_config), device="cpu")
    with torch.no_grad():  # BN statistics away from their init, so that a swap would show
        for name, buf in model.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5)
    return model


def _jax_scale_heads_index(key):
    m = re.match(r"decode_head\.scale_heads\.(\d+)\.(\d+)\.(.*)", key)
    if not m or m.group(1) == "0":
        return key
    return f"decode_head.scale_heads.{m.group(1)}.{int(m.group(2)) // 2}.{m.group(3)}"


def _assert_equal(got, want):
    missing, unexpected = tc.report_diff({k: v.shape for k, v in want.items()},
                                         {k: v.shape for k, v in got.items()})
    assert not missing and not unexpected, (missing[:5], unexpected[:5])
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("kind,mmseg", CASES, ids=[f"{k}-{'mmseg' if m else 'standalone'}"
                                                    for k, m in CASES])
def test_both_routes_give_the_model_back(kind, mmseg):
    model = _model(kind)
    want = model.state_dict()
    ref = to_reference(want, MAKERS[kind](get_config), mmseg=mmseg)
    assert any(".conv_seg." in k for k in ref) == mmseg or kind == "fpn"
    _assert_equal(tc.convert_segmentor(ref, MAKERS[kind](get_config)), want)
    jax_in = {_jax_scale_heads_index(k): v.numpy() for k, v in ref.items()}
    via_jax = convert_variables(jax_convert_segmentor(jax_in, MAKERS[kind](jax_get_config)))
    # the JAX tree has no num_batches_tracked: convert_variables writes 0, as the model has
    _assert_equal(via_jax, want)


def test_reference_layouts():
    """The inverse writes a 1x1 conv of the reference as (out, in, 1, 1)
    and leaves the others as they are."""
    cfg = small_upernet(get_config)
    ref = to_reference(_model("upernet").state_dict(), cfg)
    assert ref["backbone.stages.0.attns.0.proj_q.weight"].shape == (32, 32, 1, 1)
    assert ref["backbone.stages.0.mlps.0.linear1.0.weight"].shape == (128, 32, 1, 1)
    assert ref["decode_head.conv_seg.weight"].shape == (8, 32, 1, 1)
    assert ref["decode_head.psp_modules.0.1.conv.weight"].shape == (8, 64, 1, 1)
    assert ref["backbone.stages.0.attns.0.rpe_table"].shape == (2, 111, 111)
    assert "backbone.stages.1.attns.0.weight" in ref  # an 'X' block's window conv


def test_missing_reference_key_raises():
    cfg = small_fpn(get_config)
    ref = to_reference(_model("fpn").state_dict(), cfg)
    del ref["neck.fpn_convs.2.conv.weight"]
    with pytest.raises(KeyError, match="neck.fpn_convs.2.conv.weight"):
        tc.convert_segmentor(ref, cfg)


def test_load_pretrained_unwraps_and_merges(tmp_path):
    """A .pth as a trainer wraps it (``model`` key, DDP's ``module.``
    prefixes) loads into a fresh model with an empty report."""
    cfg = small_upernet(get_config)
    src = _model("upernet")
    ref = to_reference(src.state_dict(), cfg)
    path = tmp_path / "wrapped.pth"
    torch.save({"model": {f"module.{k}": v for k, v in ref.items()}, "meta": {"iter": 3}}, path)
    dst = _model("upernet", seed=1)
    _, report = merge_pretrained(dst, load_pretrained(str(path), cfg), verbose=False,
                                 return_report=True)
    assert report == {"missing": [], "unexpected": [], "mismatched": []}
    _assert_equal(dst.state_dict(), src.state_dict())


def test_load_pretrained_backbone_kind(tmp_path):
    """``kind='backbone'``: a checkpoint of the backbone's keys at the top
    level fills ``backbone.*`` and reports the heads as missing."""
    cfg = small_fpn(get_config)
    src = _model("fpn")
    ref = to_reference(src.state_dict(), cfg)
    path = tmp_path / "backbone.pth"
    torch.save({"state_dict": {k[len("backbone."):]: v for k, v in ref.items()
                               if k.startswith("backbone.")}}, path)
    state = load_pretrained(str(path), cfg, kind="backbone")
    assert state and all(k.startswith("backbone.") for k in state)
    dst = _model("fpn", seed=1)
    init = {k: v.clone() for k, v in dst.state_dict().items()}
    _, report = merge_pretrained(dst, state, verbose=False, return_report=True)
    assert not report["unexpected"] and not report["mismatched"]
    assert report["missing"] and all(not k.startswith("backbone.") for k in report["missing"])
    for k, v in dst.state_dict().items():
        assert torch.equal(v, (src.state_dict() if k.startswith("backbone.") else init)[k]), k


def test_merge_pretrained_reports_and_keeps_mismatched_at_init(capsys):
    """Pattern of tests/test_checkpoint_manager.py:138-176: a missing, an
    unexpected and a shape-mismatched key are each reported; the
    mismatched one stays at init, the rest is copied."""
    dst = _model("fpn", seed=1)
    init = {k: v.clone() for k, v in dst.state_dict().items()}
    state = {k: v + 1.0 if v.is_floating_point() else v for k, v in init.items()}
    del state["decode_head.cls_seg.bias"]
    state["decode_head.extra.weight"] = torch.ones(3)
    state["neck.lateral_0.bias"] = torch.ones(5)
    _, report = merge_pretrained(dst, state, verbose=True, return_report=True)
    assert report["missing"] == ["decode_head.cls_seg.bias"]
    assert report["unexpected"] == ["decode_head.extra.weight"]
    assert report["mismatched"] == [("neck.lateral_0.bias", (32,), (5,))]
    out = capsys.readouterr().out
    assert "shape-mismatched" in out and "(32,)" in out and "(5,)" in out
    got = dst.state_dict()
    assert torch.equal(got["neck.lateral_0.bias"], init["neck.lateral_0.bias"])
    assert torch.equal(got["decode_head.cls_seg.bias"], init["decode_head.cls_seg.bias"])
    np.testing.assert_array_equal(got["neck.lateral_0.weight"].numpy(),
                                  init["neck.lateral_0.weight"].numpy() + 1.0)


def test_load_pretrained_refuses_an_orbax_directory(tmp_path):
    """An orbax directory is refused; a classifier's reference .pth loads
    with kind='classifier' (the full-key route) to the model's tensors, and
    a segmentor's .pth read as a classifier lacks the head's keys."""
    import dataclasses

    with pytest.raises(ValueError, match="needs JAX"):
        load_pretrained(str(tmp_path), small_fpn(get_config))
    path = save_reference(_model("fpn"), small_fpn(get_config), tmp_path / "m.pth")
    cfg = get_config("cls_tiny_imagenet").model
    cfg = dataclasses.replace(cfg, backbone=small_fpn(get_config).backbone,
                              decode_head=dataclasses.replace(cfg.decode_head, num_classes=10))
    with pytest.raises(KeyError, match="head.norm.norm.weight"):
        load_pretrained(str(path), cfg, kind="classifier")
    torch.manual_seed(3)
    cls = build_model(cfg, device="cpu")
    cls_path = save_reference(cls, cfg, tmp_path / "cls.pth")
    _assert_equal(load_pretrained(str(cls_path), cfg, kind="classifier"), cls.state_dict())


@pytest.mark.parametrize("kind,mmseg", CASES, ids=[f"{k}-{'mmseg' if m else 'standalone'}"
                                                    for k, m in CASES])
def test_per_module_converters_equal_the_segmentor_slices(kind, mmseg):
    """convert_backbone and each head's converter (the JAX package's
    per-module API) give the segmentor converter's keys under their
    module."""
    cfg = MAKERS[kind](get_config)
    ref = to_reference(_model(kind).state_dict(), cfg, mmseg=mmseg)
    whole = tc.convert_segmentor(ref, cfg)
    n_in = len(cfg.backbone.out_indices)
    parts = {"backbone.": tc.convert_backbone(ref, cfg.backbone, "backbone.")}
    if kind == "fpn":
        parts["decode_head."] = tc.convert_fpn_head(ref, "decode_head.")
        parts["neck."] = tc.convert_fpn_neck(ref, "neck.", n_in)
    else:
        parts["decode_head."] = tc.convert_uper_head(ref, "decode_head.", n_in=n_in)
        parts["auxiliary_head."] = tc.convert_fcn_head(ref, "auxiliary_head.")
    got = {prefix + k: v for prefix, part in parts.items() for k, v in part.items()}
    _assert_equal(got, whole)
