"""The port's ImageNet data path against cv2 and the JAX package's, on the CPU.

The port makes the classifier transforms' two cv2 calls in its native
library (``native/imageops.cpp``), and they are held to cv2 bit for bit:

* ``resize_cubic_u8`` to ``cv2.resize(INTER_CUBIC)`` over random sizes, up
  and down, one and three channels. cv2 is asked for its portable C++ path
  (``cv2.ipp.setUseIPP(False)``): x86 builds of OpenCV resize uint8 images
  bicubically through Intel's IPP when it is on, which rounds otherwise (one
  grey level on about 4% of the values, measured below) and picks its code
  by the CPU's instruction set. The port reproduces OpenCV's own C++.
  The JAX functions are run the same way wherever they resize.
* ``warp_affine_u8`` to ``cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT)``
  over random shears, translations and rotations (IPP does not change it;
  its 16-output vector step is that of OpenCV's AVX2 code, which x86 builds
  dispatch to on any AVX2 host).
* the Sharpness op's smoothing to ``cv2.filter2D``, the rotation matrix to
  ``cv2.getRotationMatrix2D`` and its inverse to ``invertAffineTransform``.

Then, on the committed fixture ``tests/data/imagenet_tiny`` (remake it with
``python tests/data/make_imagenet_tiny.py``) decoded by the port's reader,
each of the 15 RandAugment ops, the train and val transforms, and
``ImageNetDataset`` items (the JAX dataset reading through the port's
decoder) equal the JAX package's bit for bit.
"""

import random
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dat_segmentation_tpu.data import imagenet as jax_imagenet
from dat_segmentation_tpu_torch import native
from dat_segmentation_tpu_torch.data import imagenet as imagenet
from dat_segmentation_tpu_torch.data.image_io import imread_rgb
from dat_segmentation_tpu_torch.data.loader import DataLoader

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent / "data" / "imagenet_tiny"
FILL = (128, 128, 128)


@pytest.fixture
def cv2_portable():
    """cv2 on its portable C++ path for the test, IPP restored after."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.fixture(scope="module")
def decoded():
    return [imread_rgb(p) for p in sorted(ROOT.rglob("*.JPEG"))]


def test_cubic_resize_equals_cv2(cv2_portable):
    rng = np.random.default_rng(0)
    for t in range(160):
        h, w, dh, dw = (int(v) for v in rng.integers(1, 300, 4))
        if t % 4 == 0:  # the classifier's own: a crop to 224, an image to 256 short side
            dh = dw = 224
        shape = (h, w) if t % 5 == 0 else (h, w, 3)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_CUBIC)
        got = native.resize_cubic_u8(img, (dw, dh))
        assert got.shape == want.shape and np.array_equal(got, want), (shape, dh, dw)


def test_cubic_resize_ipp_difference():
    """cv2's IPP path against its portable one, and so against the port:
    at most one grey level (4.2% of the values at 224² differ)."""
    rng = np.random.default_rng(1)
    was = cv2.ipp.useIPP()
    off = total = 0
    try:
        for _ in range(20):
            h, w = (int(v) for v in rng.integers(96, 321, 2))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            cv2.ipp.setUseIPP(True)
            ipp = cv2.resize(img, (224, 224), interpolation=cv2.INTER_CUBIC).astype(int)
            got = native.resize_cubic_u8(img, (224, 224)).astype(int)
            assert np.abs(ipp - got).max() <= 1
            off += int((ipp != got).sum())
            total += ipp.size
    finally:
        cv2.ipp.setUseIPP(was)
    assert off < 0.1 * total


def test_warp_affine_equals_cv2():
    rng = np.random.default_rng(2)
    for t in range(90):
        h, w = (int(v) for v in rng.integers(2, 300, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        kind = t % 3
        if kind == 2:
            m = cv2.getRotationMatrix2D(((w - 1) / 2, (h - 1) / 2), float(rng.uniform(-30, 30)), 1.0)
            want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                                  borderMode=cv2.BORDER_CONSTANT, borderValue=FILL)
            got = native.warp_affine_u8(img, m, 128, inverse_map=False)
        else:
            s, p = rng.uniform(-0.3, 0.3), rng.uniform(-0.45, 0.45) * (w if kind else h)
            m = np.float32([[1, s, p], [0, 1, 0]] if kind else [[1, 0, 0], [s, 1, p]])
            want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                                  borderMode=cv2.BORDER_CONSTANT, borderValue=FILL)
            got = native.warp_affine_u8(img, m, 128)
        assert np.array_equal(got, want), (t, h, w)


def test_geometry_helpers_equal_cv2():
    rng = np.random.default_rng(3)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(2, 400, 2))
        deg = float(rng.uniform(-30, 30))
        centre = ((w - 1) / 2, (h - 1) / 2)
        m = imagenet.rotation_matrix(centre, deg)
        assert np.array_equal(m, cv2.getRotationMatrix2D(centre, deg, 1.0))
        assert np.array_equal(native.invert_affine(m), cv2.invertAffineTransform(m))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.filter2D(img, -1, imagenet._SMOOTH, borderType=cv2.BORDER_REPLICATE)
        assert np.array_equal(imagenet.smooth3x3(img), want)


@pytest.mark.parametrize("name", list(jax_imagenet.RAND_AUGMENT_OPS))
def test_rand_augment_op_equals_jax(name, decoded, cv2_portable):
    """Each op at three levels on three fixture images (after the train
    crop, as RandAugment sees them, and as decoded), same draws."""
    assert list(imagenet.RAND_AUGMENT_OPS) == list(jax_imagenet.RAND_AUGMENT_OPS)
    for i, img in enumerate(decoded[:3]):
        crop = imagenet.random_resized_crop(img, random.Random(i))
        for level in (0.0, 4.5, 10.0):
            for src in (crop, img):
                want = jax_imagenet.RAND_AUGMENT_OPS[name](src.copy(), level, random.Random(level))
                got = imagenet.RAND_AUGMENT_OPS[name](src.copy(), level, random.Random(level))
                assert got.dtype == np.uint8 and np.array_equal(got, want), (i, level)


def test_transforms_equal_jax(decoded, cv2_portable):
    for i, img in enumerate(decoded):
        for seed in range(3):
            want = jax_imagenet.train_transform_cls(img.copy(), random.Random(f"{seed}:{i}"))
            got = imagenet.train_transform_cls(img.copy(), random.Random(f"{seed}:{i}"))
            assert got.shape == (224, 224, 3) and got.dtype == np.float32
            assert np.array_equal(got, want), (i, seed)
        want = jax_imagenet.val_transform_cls(img.copy())
        assert np.array_equal(imagenet.val_transform_cls(img.copy()), want), i
    small = imagenet.random_resized_crop(decoded[0], random.Random(0), size=64)
    assert np.array_equal(small, jax_imagenet.random_resized_crop(decoded[0], random.Random(0),
                                                                 size=64))


class _JaxDatasetPortDecoder(jax_imagenet.ImageNetDataset):
    """The JAX dataset reading through the port's decoder (its
    ``__getitem__`` with ``imread_rgb`` for ``cv2.imread``)."""

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = imread_rgb(path)
        if self.is_train:
            rng = random.Random(f"{self.seed}:{self.epoch}:{idx}")
            img = jax_imagenet.train_transform_cls(img, rng, size=self.size)
        else:
            img = jax_imagenet.val_transform_cls(img, size=self.size)
        return {"image": img, "label": np.int32(label)}


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_items_equal_jax(split, cv2_portable):
    port = imagenet.ImageNetDataset(str(ROOT), split, seed=5)
    ref = _JaxDatasetPortDecoder(str(ROOT), split, seed=5)
    assert len(port) == len(ref) == {"train": 12, "val": 6}[split]
    assert port.class_to_idx == ref.class_to_idx == {"n000": 0, "n001": 1, "n002": 2}
    assert [(str(p), c) for p, c in port.samples] == [(str(p), c) for p, c in ref.samples]
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for idx in range(0, len(port), 2):
            a, b = port[idx], ref[idx]
            assert a["label"] == b["label"] and a["label"].dtype == np.int32
            assert np.array_equal(a["image"], b["image"]), (epoch, idx)
    if split == "train":  # a new epoch draws anew
        port.set_epoch(0)
        first = port[0]["image"]
        port.set_epoch(1)
        assert not np.array_equal(first, port[0]["image"])


def test_loader_batches_are_the_items():
    ds = imagenet.ImageNetDataset(str(ROOT), "val")
    batches = list(DataLoader(ds, 4, drop_last=False, num_threads=2))
    assert [b["image"].shape for b in batches] == [(4, 224, 224, 3), (2, 224, 224, 3)]
    assert np.array_equal(batches[1]["image"][1], ds[5]["image"])
    assert batches[0]["label"].tolist() == [0, 0, 1, 1]


def test_fixture_layout():
    """3 classes x (4 train + 2 val) JPEGs of 96-320 px, none square."""
    shapes = [imread_rgb(p).shape for p in sorted(ROOT.rglob("*.JPEG"))]
    assert len(shapes) == 18
    assert all(96 <= min(s[:2]) and max(s[:2]) <= 320 and s[0] != s[1] for s in shapes)
