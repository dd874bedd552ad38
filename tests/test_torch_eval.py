"""The port's SegInferencer beyond whole mode at multiples of 32: whole mode
at any size, slide mode, the TTA inputs and the multi-scale + flip
``predict``, against the JAX SegInferencer on the CPU.

The JAX inferencer runs its exact padded inference (``exact=True``, which
is proven equal to the true-shape forward), float32 compute and transfer,
and resizes on the host with cv2; the port forwards every image at its
true shape and resizes with ``F.interpolate`` (the same half-pixel
bilinear rule). Float32 throughout, summed in other orders: logits within
1e-4. Both resize the raw uint8 image in cv2's fixed point (the port in
integer PyTorch ops): TTA inputs equal, bit for bit. Class maps
are equal except where the JAX top two probabilities are within 1e-5 (an
argmax near-tie that rounding may flip). The image sizes keep every
stage's grid at least 2 wide (the reference grid divides by its size - 1).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.eval.inference import SegInferencer as JaxSegInferencer
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
from dat_segmentation_tpu_torch.eval.inference import MS_RATIOS
from torch_port_helpers import carry, random_variables, small_fpn

ATOL = 1e-4
NEAR_TIE = 1e-5
SCALE = (256, 128)  # (W, H): MS_RATIOS give 64x90 .. 224x314 from a 100x140 image


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(small_fpn(jax_get_config))
    variables = random_variables(jmodel, np.zeros((1, 64, 64, 3), np.float32), seed=4,
                                 train=False)
    jinf = JaxSegInferencer(jmodel, variables, num_classes=8, exact=True,
                            compute_dtype=jnp.float32, transfer_dtype=jnp.float32)
    torch.manual_seed(0)
    pmodel = carry(build_model(small_fpn(get_config), device="cpu"), variables)
    pinf = SegInferencer(pmodel, num_classes=8, compute_dtype=torch.float32, device="cpu")
    return jinf, pinf


def _set(inf, mode, crop=(512, 512), stride=(341, 341)):
    inf.mode, inf.crop_size, inf.stride = mode, crop, stride


def _img(h, w, seed=11):
    return np.random.RandomState(seed).randn(h, w, 3).astype(np.float32)


def test_whole_mode_at_any_size(pair):
    jinf, pinf = pair
    _set(jinf, "whole"), _set(pinf, "whole")
    img = _img(70, 100)
    ref = jinf.logits(img)
    got = pinf.logits(img)
    assert got.shape == ref.shape == (70, 100, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "size,crop,stride",
    [
        ((100, 130), (64, 64), (40, 48)),  # 2 x 3 full windows, overlapping
        ((70, 100), (96, 96), (64, 64)),   # shorter than the crop: 70 x 96 windows
    ],
    ids=["full_windows", "image_smaller_than_crop"],
)
def test_slide_mode_matches_jax(pair, size, crop, stride):
    jinf, pinf = pair
    _set(jinf, "slide", crop, stride), _set(pinf, "slide", crop, stride)
    img = _img(*size, seed=12)
    ref = jinf.logits_slide(img)
    got = pinf.logits_slide(img)
    assert got.shape == ref.shape == (*size, 8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _raw(h=100, w=140, seed=13):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def test_tta_inputs_equal_jax(pair):
    jinf, pinf = pair
    raw = _raw()
    kw = dict(img_scale=SCALE, ratios=MS_RATIOS, flip=True)
    ref = list(jinf.tta_inputs(raw, **kw))
    got = list(pinf.tta_inputs(raw, **kw))
    assert [f for _, f in got] == [f for _, f in ref] and len(got) == 2 * len(MS_RATIOS)
    for (g, _), (r, _) in zip(got, ref):
        g = g.cpu().numpy()
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, r)


def _near_ties(probs):
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] <= NEAR_TIE


def _jax_probs(jinf, raw, ratios, flip):
    """The JAX predict's averaged probabilities (its own helpers)."""
    from dat_segmentation_tpu.eval.inference import _np_softmax, _resize_probs

    ori = raw.shape[:2]
    acc, n = 0.0, 0
    for inp, do_flip in jinf.tta_inputs(raw, img_scale=SCALE, ratios=ratios, flip=flip):
        logits = jinf.logits(inp)
        if do_flip:
            logits = logits[:, ::-1]
        if logits.shape[:2] != ori:
            logits = _resize_probs(logits, ori)
        acc, n = acc + _np_softmax(logits), n + 1
    return acc / n


@pytest.mark.parametrize("mode", ["whole", "slide"])
def test_predict_ms_flip_matches_jax(pair, mode, monkeypatch):
    """MS_RATIOS with flip in whole mode; one scale without flip in slide
    mode (crops 64 x 64 at stride 48). Both predicts see the JAX TTA
    inputs (cv2's uint8 resizes; the port's own are held to them above),
    so that what is compared is the rest of the pipeline."""
    jinf, pinf = pair
    _set(jinf, mode, (64, 64), (48, 48)), _set(pinf, mode, (64, 64), (48, 48))
    raw = _raw()
    ratios, flip = (MS_RATIOS, True) if mode == "whole" else ((1.0,), False)

    def jax_inputs(raw_img, **kw):
        for inp, do_flip in jinf.tta_inputs(raw_img, **kw):
            yield torch.from_numpy(inp.copy()), do_flip

    monkeypatch.setattr(pinf, "tta_inputs", jax_inputs)
    ref = jinf.predict(raw, img_scale=SCALE, ratios=ratios, flip=flip)
    got = pinf.predict(raw, img_scale=SCALE, ratios=ratios, flip=flip)
    assert got.shape == ref.shape == raw.shape[:2] and got.dtype == np.int32
    differ = got != ref
    if differ.any():
        ties = _near_ties(_jax_probs(jinf, raw, ratios, flip))
        assert not (differ & ~ties).any(), int((differ & ~ties).sum())
    assert differ.mean() < 1e-3
