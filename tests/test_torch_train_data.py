"""The port's train data path against the JAX package's, on the CPU.

On the committed fixture ``tests/data/ade20k_tiny`` (six images at ADE20K
shapes): the train transform, bit for bit, against the JAX package's native
branch (``DAT_TPU_NATIVE=1`` with its ``libimageops.so``; its cv2 branch
draws in another order) on the same raw arrays, over enough items to take
every branch; the port's copy of the native library against the JAX one,
input for input; a train item of the dataset against the JAX dataset's
with the port's decoder (Pillow decodes JPEG a grey level off cv2 on a few
pixels); ``DataLoader`` against the JAX one; ``device_prefetch`` on the
CPU; the uint8 resize against ``cv2.resize`` at the train ratios, whose
sides are not kept in proportion.
"""

import random
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dat_segmentation_tpu import native as jax_native
from dat_segmentation_tpu.data import ade20k as jax_ade
from dat_segmentation_tpu.data.loader import DataLoader as JaxDataLoader
from dat_segmentation_tpu_torch import native
from dat_segmentation_tpu_torch.data import ade20k as ade
from dat_segmentation_tpu_torch.data.loader import DataLoader, device_prefetch
from dat_segmentation_tpu_torch.data.image_io import imread_gray, imread_rgb
from dat_segmentation_tpu_torch.ops.interpolate import resize_uint8_linear

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent / "data" / "ade20k_tiny"
CROP = (512, 512)


@pytest.fixture
def jax_native_on(monkeypatch):
    monkeypatch.setenv("DAT_TPU_NATIVE", "1")
    assert jax_native.enabled(), "the JAX package's libimageops.so did not build"


@pytest.fixture(scope="module")
def raws():
    ds = ade.ADE20KDataset(ROOT, "val")
    return [ds.load_raw(i) for i in range(len(ds))]


class _LoggedRandom(random.Random):
    """random.Random that logs which kind of draw came when. (It defines
    ``getrandbits`` so that ``randint`` keeps drawing through it: a
    subclass that overrides only ``random`` gets other integers.)"""

    def __init__(self, seed):
        self.log = []
        super().__init__(seed)

    def getrandbits(self, k):
        return super().getrandbits(k)

    def random(self):
        v = super().random()
        self.log.append(("random", v))
        return v

    def randint(self, a, b):
        v = super().randint(a, b)
        self.log.append(("randint", v))
        return v


def _flipped(log):
    """The flip's draw: the first ``random()`` after the crop's randints."""
    first_randint = next(i for i, (k, _) in enumerate(log) if k == "randint")
    return next(v for k, v in log[first_randint:] if k == "random") < 0.5


def test_train_transform_equals_jax_native(raws, jax_native_on, monkeypatch):
    """36 items (six images, six epochs) at the recipe's 512² crop, plus
    both ends of the ratio range: every output equal, and between them
    every branch taken both ways: pad before the crop, flip, brightness,
    contrast, both modes, saturation, hue."""
    seen = {"pad": set(), "flip": set(), "bright": set(), "mode": set(), "alpha": set(),
            "sat": set(), "hue": set()}
    real_photo, real_pad = native.photometric_distortion_u8, ade.pad_to_size

    def photo_spy(img, **kw):
        seen["bright"].add(kw["brightness"] != 0.0)
        seen["alpha"].add(kw["contrast"] != 1.0)
        seen["sat"].add(kw["saturation"] != 1.0)
        seen["hue"].add(kw["hue"] != 0.0)
        seen["mode"].add(kw["contrast_first"])
        return real_photo(img, **kw)

    pads = []

    def pad_spy(img, *a, **kw):
        pads.append(img.shape)
        return real_pad(img, *a, **kw)

    monkeypatch.setattr(native, "photometric_distortion_u8", photo_spy)
    monkeypatch.setattr(ade, "pad_to_size", pad_spy)
    cases = [(i, f"0:{e}:{i}", (0.5, 2.0)) for e in range(6) for i in range(len(raws))]
    cases += [(0, "ends", (0.5, 0.5)), (2, "ends", (2.0, 2.0))]
    for i, key, ratio_range in cases:
        img, mask = raws[i]
        rng = _LoggedRandom(key)
        pads.clear()
        got = ade.train_transform(img, mask, rng, crop_size=CROP, ratio_range=ratio_range)
        ref = jax_ade.train_transform(img, mask, random.Random(key), crop_size=CROP,
                                      ratio_range=ratio_range)
        assert got[0].dtype == ref[0].dtype == np.float32 and got[1].dtype == ref[1].dtype == np.int32
        assert got[0].shape == (512, 512, 3) and got[1].shape == (512, 512)
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"image {i} {key}")
        np.testing.assert_array_equal(got[1], ref[1], err_msg=f"mask {i} {key}")
        seen["pad"].add(any(s[0] < CROP[1] or s[1] < CROP[0] for s in pads))
        seen["flip"].add(_flipped(rng.log))
    assert all(v == {False, True} for v in seen.values()), seen


@pytest.mark.parametrize("size", [(37, 53), (64, 96)], ids=["odd", "even"])
def test_native_copy_equals_jax_library(size, jax_native_on):
    rng = np.random.RandomState(sum(size))
    img = rng.randint(0, 256, size + (3,), np.uint8)
    img[:4] = 0  # flat and saturated corners: hue 0, v 0 and 255
    img[-4:] = 255
    img[4:8, :, 1] = img[4:8, :, 0]
    params = [dict(), dict(brightness=17.3, contrast=1.31, saturation=0.62, hue=-11.5),
              dict(brightness=-30.1, contrast=0.55, saturation=1.4, hue=17.9, contrast_first=True),
              dict(contrast=1.49, contrast_first=True), dict(hue=0.3, saturation=1.5)]
    for kw in params:
        got = native.photometric_distortion_u8(img, **kw)
        ref = jax_native.photometric_distortion_u8(img, **kw)
        np.testing.assert_array_equal(got, ref, err_msg=str(kw))
        np.testing.assert_array_equal(native.normalize_pad_f32(got, ade.IMG_NORM_MEAN,
                                                               ade.IMG_NORM_STD, 70, 100, 0.5),
                                      jax_native.normalize_pad_f32(ref, jax_ade.IMG_NORM_MEAN,
                                                                   jax_ade.IMG_NORM_STD, 70, 100,
                                                                   0.5))


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "imageops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="imageops.cpp.*\n.*error"):
            native.load()
    finally:
        native.load.cache_clear()


class _JaxDatasetPortDecoder(jax_ade.ADE20KDataset):
    """The JAX dataset reading through the port's decoder."""

    def load_raw(self, idx):
        mask = imread_gray(self.masks[idx])
        return imread_rgb(self.images[idx]), jax_ade.reduce_zero_label(mask, self.ignore_index)


def _train_layout(tmp_path):
    """The fixture's six images as a train split (the other layout)."""
    for sub in ("img", "annotations"):
        (tmp_path / "train" / sub).mkdir(parents=True)
    for p in sorted((ROOT / "images" / "validation").glob("*.jpg")):
        (tmp_path / "train" / "img" / p.name).symlink_to(p)
        (tmp_path / "train" / "annotations" / f"{p.stem}.png").symlink_to(
            ROOT / "annotations" / "validation" / f"{p.stem}.png")
    return tmp_path


def test_train_items_equal_jax(tmp_path, jax_native_on):
    root = _train_layout(tmp_path)
    got = ade.ADE20KDataset(root, "train", crop_size=(128, 96), seed=3)
    ref = _JaxDatasetPortDecoder(root, "train", crop_size=(128, 96), seed=3)
    assert got.is_train and len(got) == len(ref) == 6
    for epoch in (0, 2):
        got.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(got)):
            a, b = got[i], ref[i]
            assert a["path"] == b["path"]
            assert a["image"].shape == (96, 128, 3)
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


class _IndexDataset:
    """Items that name their index and the epoch they were drawn in."""

    def __init__(self, n):
        self.n, self.epoch = n, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return {"image": np.full((2, 3), idx, np.float32),
                "label": np.array([idx, self.epoch], np.int32), "path": f"p{idx}"}


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True, seed=5, infinite=True, epoch=2),
    dict(shuffle=False, drop_last=False),
    dict(shuffle=True, drop_last=False, seed=1, shard_info=(1, 3)),
    dict(shuffle=True, drop_last=True, seed=7, shard_info=(0, 2), infinite=True),
], ids=["infinite", "plain", "shard", "shard_infinite"])
def test_dataloader_equals_jax(kw):
    import itertools

    n_batches = 12 if kw.get("infinite") else None
    got = DataLoader(_IndexDataset(11), 3, num_threads=2, **kw)
    ref = JaxDataLoader(_IndexDataset(11), 3, num_threads=2, **kw)
    assert len(got) == len(ref)
    a = list(itertools.islice(iter(got), n_batches))
    b = list(itertools.islice(iter(ref), n_batches))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y) and x["path"] == y["path"]
        np.testing.assert_array_equal(x["image"], y["image"])
        np.testing.assert_array_equal(x["label"], y["label"])


def test_dataloader_warns_on_frozen_epoch_reuse():
    ds = _IndexDataset(4)
    DataLoader(ds, 2, shuffle=True, seed=11)
    with pytest.warns(UserWarning, match="repeats the previous one"):
        DataLoader(ds, 2, shuffle=True, seed=11)


def test_device_prefetch_keeps_order_and_raises_the_producers_error():
    batches = [{"image": np.full((2, 2), i, np.float32), "path": [f"p{i}"]} for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu"))
    assert [int(b["image"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["image"], torch.Tensor) and b["path"] == [f"p{i}"]
               for i, b in enumerate(out))

    def failing():
        yield batches[0]
        raise KeyError("decode failed")

    gen = device_prefetch(failing(), "cpu")
    assert int(next(gen)["image"][0, 0]) == 0
    with pytest.raises(KeyError, match="decode failed"):
        next(gen)


def test_device_prefetch_close_stops_the_producer():
    import itertools
    import threading

    def endless():
        for i in itertools.count():
            yield {"image": np.full((1,), i, np.float32)}

    gen = device_prefetch(endless(), "cpu")
    assert [int(next(gen)["image"][0]) for _ in range(3)] == [0, 1, 2]
    gen.close()
    assert not any(t.name == "device_prefetch" and t.is_alive() for t in threading.enumerate())


@pytest.mark.parametrize("ratio", [0.5, 2.0])
def test_resize_matches_cv2_at_train_ratios(raws, ratio):
    """The train resize (no kept aspect ratio: a 512-wide image to 4096 at
    ratio 2) against cv2's uint8 INTER_LINEAR and INTER_NEAREST, on each
    of the fixture's sizes."""
    sizes = set()
    for img, mask in raws:
        if img.shape in sizes:
            continue
        sizes.add(img.shape)
        ow, oh = int(2048 * ratio), int(512 * ratio)
        got = resize_uint8_linear(torch.from_numpy(img), (oh, ow)).numpy()
        np.testing.assert_array_equal(got, cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR))
        gi, gm = ade.resize(img, mask, ratio=ratio)
        ri, rm = jax_ade.resize(img, mask, ratio=ratio)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gm, rm)
    assert len(sizes) >= 2
