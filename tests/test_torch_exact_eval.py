"""Exact padded inference in the port against the JAX package, float32 on
the CPU.

A zero-padded batch of images of different true sizes, each with its
(h, w) in ``valid_hw``, must give on each image's valid region what that
image gives alone at its true shape (``ops/valid_extent.py``). Each case
runs the port and the JAX package on the same numpy-seeded padded batch
with the same carried variables, and the port's true-shape forward, on the
small geometry of the JAX package's own ``tests/test_exact_eval.py``
(depths 1-1-2-1, dims 16-128, images 52x76 and 61x64 in a 64x96 bucket).
Tolerance 1e-4 on the stride-4 logits, as the JAX tests gate the exact
forward against the true-shape one. One module fixture computes every JAX
forward (each through ``jax.jit``: a compile a shape).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.eval.inference import SegInferencer as JaxSegInferencer
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.ops import valid_extent as jve
from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
from dat_segmentation_tpu_torch.models import dat as tdat
from dat_segmentation_tpu_torch.models.deformable_attention import DeformableAttention
from dat_segmentation_tpu_torch.ops import deform_attn as tda
from dat_segmentation_tpu_torch.ops import valid_extent as ve
from torch_port_helpers import carry, random_variables

ATOL = 1e-4
PAD = (64, 96)
SHAPES = ((52, 76), (61, 64))
VARIANTS = {  # the five of the JAX test_exact_attention_variants: (backbone fields, shape, pad)
    "tanh_range": (dict(offset_range_factor=(2.0, 2.0, 2.0, 2.0)), (52, 76), PAD),
    "no_off": (dict(no_offs=(True,) * 4), (64, 64), (96, 96)),  # true sizes stride-divisible
    "log_cpb": (dict(log_cpb=(True,) * 4), (52, 76), PAD),
    "dwc_pe": (dict(dwc_pes=(True,) * 4, use_pes=(True,) * 4), (52, 76), PAD),
    "fixed_pe": (dict(fixed_pes=(True,) * 4), (52, 76), PAD),
}


def tiny(get_config, preset="upn_tiny_160k_dp03_lr6", **backbone):
    """The JAX exact-eval tests' ``_tiny_model`` geometry, either package."""
    cfg = get_config(preset).model
    bb = dataclasses.replace(
        cfg.backbone, depths=(1, 1, 2, 1), dims=(16, 32, 64, 128), dim_stem=16,
        heads=(2, 2, 4, 4), groups=(1, 2, 2, 4),
        stage_spec=(("D",), ("X", "D"), ("X", "D"), ("D",)), drop_path_rate=0.0, **backbone)
    return dataclasses.replace(cfg, backbone=bb)


def padded_batch(shapes, pad, seed):
    rng = np.random.RandomState(seed)
    imgs = [rng.randn(h, w, 3).astype(np.float32) for h, w in shapes]
    x = np.zeros((len(shapes), *pad, 3), np.float32)
    for i, im in enumerate(imgs):
        x[i, :im.shape[0], :im.shape[1]] = im
    return imgs, x, np.asarray(shapes, np.int32)


def ext4(hw):
    return tuple(int(v) for v in ve.stride4_extent(hw, conv_stem=True))


class Case:
    """One configuration on both sides: the JAX model and variables, the
    port model carrying them, a padded batch and the JAX exact forward."""

    def __init__(self, preset="upn_tiny_160k_dp03_lr6", shapes=SHAPES[:1], pad=PAD, seed=1,
                 **backbone):
        self.jmodel = jax_build_model(tiny(jax_get_config, preset, **backbone))
        self.variables = random_variables(self.jmodel, np.zeros((1, 64, 64, 3), np.float32),
                                          seed=seed, train=False)
        self.cfg = tiny(get_config, preset, **backbone)
        self.port = carry(build_model(self.cfg, device="cpu"), self.variables)
        self.imgs, self.x, self.valid = padded_batch(shapes, pad, seed + 10)
        fwd = jax.jit(lambda v, x, hw: self.jmodel.apply(v, x, train=False, upsample=False,
                                                         valid_hw=hw))
        tree = jax.tree_util.tree_map(jnp.asarray, self.variables)
        self.jax_exact = np.asarray(fwd(tree, jnp.asarray(self.x), jnp.asarray(self.valid)))

    def port_exact(self, model=None):
        with torch.no_grad():
            return (model or self.port)(torch.from_numpy(self.x), upsample=False,
                                        valid_hw=torch.from_numpy(self.valid)).numpy()

    def port_true(self, i, model=None):
        with torch.no_grad():
            return (model or self.port)(torch.from_numpy(self.imgs[i][None]),
                                        upsample=False).numpy()[0]

    def check(self, got, name):
        """Each sample's valid region of ``got`` against the JAX exact
        forward and against the port's own true-shape forward."""
        for i, (h, w) in enumerate(self.valid):
            eh, ew = ext4((h, w))
            true = self.port_true(i)
            assert true.shape[:2] == (eh, ew)
            np.testing.assert_allclose(got[i, :eh, :ew], self.jax_exact[i, :eh, :ew], rtol=0,
                                       atol=ATOL, err_msg=f"{name} sample {i}: against JAX")
            np.testing.assert_allclose(got[i, :eh, :ew], true, rtol=0, atol=ATOL,
                                       err_msg=f"{name} sample {i}: against its true shape")


@pytest.fixture(scope="module")
def cases():
    out = {"upernet": Case(), "fpn": Case("fpn_tiny_80k_dp04_lr2", seed=2),
           "mixed": Case(shapes=SHAPES, seed=3)}
    for name, (backbone, shape, pad) in VARIANTS.items():
        out[name] = Case(shapes=(shape,), pad=pad, seed=4, **backbone)
    return out


# -- the valid_extent helpers -------------------------------------------------


def _draw(seed=0):
    rng = np.random.RandomState(seed)
    ext = np.stack([rng.randint(1, 20, 3), rng.randint(1, 28, 3)], 1).astype(np.int32)
    return rng, ext


HELPERS = ["conv_out_extent", "stride4_extent", "mask_tensor_grouped", "resize_bilinear",
           "resize_bilinear_align_corners", "resize_nearest", "adaptive_avg_pool"]


@pytest.mark.parametrize("helper", HELPERS)
def test_valid_extent_helpers_equal_jax(helper):
    """Each helper of the port's ``ops/valid_extent.py`` against the JAX
    module's on drawn extents (3 samples within a 20x28 map)."""
    rng, ext = _draw()
    text, jext = torch.from_numpy(ext), jnp.asarray(ext)
    x = rng.randn(3, 20, 28, 5).astype(np.float32)
    if helper == "conv_out_extent":
        for k, s, p in ((3, 2, 1), (9, 8, 4), (2, 2, 0), (4, 4, 0), (3, 1, 1)):
            np.testing.assert_array_equal(ve.conv_out_extent(text, k, s, p).numpy(),
                                          np.asarray(jve.conv_out_extent(jext, k, s, p)))
        return
    if helper == "stride4_extent":
        hw = rng.randint(5, 700, (10, 2))
        for conv_stem in (True, False):
            np.testing.assert_array_equal(ve.stride4_extent(hw, conv_stem),
                                          jve.stride4_extent(hw, conv_stem))
        return
    if helper == "mask_tensor_grouped":  # a (B*g) batch: sample-major repeats
        xg = rng.randn(6, 20, 28, 5).astype(np.float32)
        np.testing.assert_array_equal(ve.mask_tensor(torch.from_numpy(xg), text).numpy(),
                                      np.asarray(jve.mask_tensor(jnp.asarray(xg), jext)))
        return
    if helper == "adaptive_avg_pool":
        for out in ((1, 1), (2, 2), (3, 3), (6, 6)):
            np.testing.assert_allclose(
                ve.adaptive_avg_pool_extent(torch.from_numpy(x), out, text).numpy(),
                np.asarray(jve.adaptive_avg_pool_extent(jnp.asarray(x), out, jext)),
                rtol=0, atol=1e-6)
        return
    dst = np.stack([rng.randint(1, 40, 3), rng.randint(1, 56, 3)], 1).astype(np.int32)
    tdst, jdst = torch.from_numpy(dst), jnp.asarray(dst)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if helper == "resize_nearest":
        got = ve.resize_nearest_extent(tx, (40, 56), text, tdst)
        ref = jve.resize_nearest_extent(jx, (40, 56), jext, jdst)
    else:
        ac = helper.endswith("align_corners")
        got = ve.resize_bilinear_extent(tx, (40, 56), text, tdst, align_corners=ac)
        ref = jve.resize_bilinear_extent(jx, (40, 56), jext, jdst, align_corners=ac)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


# -- the exact padded forward -----------------------------------------------------


@pytest.mark.parametrize("name", ["upernet", "fpn", "mixed"])
def test_exact_padded_forward_equals_jax_and_true_shape(cases, name):
    """UperNet and SemanticFPN, one 52x76 image in a 64x96 bucket, and a
    UperNet batch of 52x76 and 61x64 in one bucket."""
    case = cases[name]
    got = case.port_exact()
    assert got.shape == case.jax_exact.shape == (len(case.imgs), 16, 24, 150)
    case.check(got, name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_exact_attention_variants(cases, variant, monkeypatch):
    """The attention modes of the JAX ``test_exact_attention_variants``,
    all four stages in the mode. None runs K1 (counted: the CPU route
    counts no launch, so the op is watched)."""
    calls = []
    real = tda.deform_attn
    monkeypatch.setattr("dat_segmentation_tpu_torch.models.deformable_attention.deform_attn",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    case = cases[variant]
    got = case.port_exact()
    assert not calls
    case.check(got, variant)


def test_exact_mode_gates_k1_off(cases, monkeypatch):
    """The continuous bias runs K1 (its plain version here) on the padded
    batch without ``valid_hw`` and at the true shape, and the composite
    under exact mode, as the JAX gate routes it."""
    calls = []
    real = tda.deform_attn
    monkeypatch.setattr("dat_segmentation_tpu_torch.models.deformable_attention.deform_attn",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    case = cases["upernet"]
    n_d = sum(isinstance(m, DeformableAttention) for m in case.port.modules())
    case.port_exact()
    assert not calls
    case.port_true(0)
    assert len(calls) == n_d > 0
    assert all(m.runs_kernel() and not m.runs_kernel(exact=True)
               for m in case.port.modules() if isinstance(m, DeformableAttention))


def test_pallas_under_exact_takes_the_unfused_chain(cases, monkeypatch):
    """``kernel_impl='pallas'``: K3 (its plain version here) runs on the
    plain forward of the image zero-padded to 64x128 (stage 1, 32 wide, is
    8x16 there), and not under exact mode, at 64x128 or in the 64x96
    bucket, where the unfused chain gives the true-shape forward's and
    the JAX exact forward's numbers."""
    case = cases["upernet"]
    cfg = dataclasses.replace(case.cfg, backbone=dataclasses.replace(case.cfg.backbone,
                                                                     kernel_impl="pallas"))
    model = carry(build_model(cfg, device="cpu"), case.variables)
    calls = []
    for name in ("fused_x_block", "fused_conv_mlp"):
        real = getattr(tdat, name)
        monkeypatch.setattr(tdat, name, lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
    img = case.imgs[0]
    x = torch.zeros(1, 64, 128, 3)
    x[0, :img.shape[0], :img.shape[1]] = torch.from_numpy(img)
    with torch.no_grad():
        model(x, upsample=False)
        assert calls, "K3's gate is shut on the plain padded forward"
        calls.clear()
        wide = model(x, upsample=False, valid_hw=torch.from_numpy(case.valid)).numpy()
    got = case.port_exact(model)
    assert not calls
    eh, ew = ext4(img.shape[:2])
    np.testing.assert_allclose(wide[0, :eh, :ew], case.port_true(0), rtol=0, atol=ATOL)
    case.check(got, "pallas")


def test_inferencer_bucket_equals_true_shape_and_jax(cases):
    """``SegInferencer(bucket=32)`` (exact) against ``bucket=1`` (each image
    at its true shape) in whole mode, and ``forward_batch`` with
    ``valid_hw`` against the JAX inferencer's."""
    case = cases["mixed"]
    kw = dict(num_classes=150, compute_dtype=torch.float32, device="cpu")
    pad, ref = SegInferencer(case.port, bucket=32, **kw), SegInferencer(case.port, **kw)
    for img in case.imgs:
        got, want = pad.logits_whole(img), ref.logits_whole(img)
        assert got.shape == want.shape == (*img.shape[:2], 150)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    jinf = JaxSegInferencer(case.jmodel, case.variables, num_classes=150, bucket=32, exact=True,
                            compute_dtype=jnp.float32, transfer_dtype=jnp.float32)
    want = jinf.forward_batch(case.x, valid_hw=case.valid)
    got = pad.forward_batch(case.x, valid_hw=case.valid).numpy()
    for i, hw in enumerate(case.valid):
        assert pad._ext4(hw) == tuple(jinf._ext4(hw))
        eh, ew = pad._ext4(hw)
        np.testing.assert_allclose(got[i, :eh, :ew], want[i, :eh, :ew], rtol=0, atol=ATOL)


def test_no_exact_equals_the_jax_plain_padded_path(cases):
    """``exact=False``: the plain zero-pad forward, its logits resized to the
    bucket and sliced, against the JAX inferencer's (``_fwd``); it is not
    the true-shape forward."""
    case = cases["upernet"]
    img = case.imgs[0]
    jinf = JaxSegInferencer(case.jmodel, case.variables, num_classes=150, bucket=32, exact=False,
                            compute_dtype=jnp.float32, transfer_dtype=jnp.float32)
    kw = dict(num_classes=150, compute_dtype=torch.float32, device="cpu")
    plain = SegInferencer(case.port, bucket=32, exact=False, **kw)
    got, want = plain.logits_whole(img), jinf.logits_whole(img)
    assert got.shape == want.shape == (52, 76, 150)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    true = SegInferencer(case.port, **kw).logits_whole(img)
    assert np.abs(got - true).max() > 10 * ATOL
    # forward_batch ignores valid_hw on the plain path
    np.testing.assert_array_equal(plain.forward_batch(case.x, valid_hw=case.valid).numpy(),
                                  plain.forward_batch(case.x).numpy())


def test_valid_hw_refuses_what_the_jax_eval_does_not_run(cases):
    """``upsample=True`` raises, as the JAX segmentor does; so do a row
    shard and a model split over the model axis."""
    case = cases["upernet"]
    x, valid = torch.from_numpy(case.x), torch.from_numpy(case.valid)
    with torch.no_grad():
        with pytest.raises(ValueError, match="upsample=False"):
            case.port(x, valid_hw=valid)
        with pytest.raises(ValueError, match="outside the mesh"):
            case.port(x, upsample=False, valid_hw=valid, rows=object())
        try:
            case.port.model_axis = object()
            with pytest.raises(ValueError, match="outside the mesh"):
                case.port(x, upsample=False, valid_hw=valid)
        finally:
            del case.port.model_axis
    assert ve.current() is None
