"""ImageNet folder dataset and the classifier's train and val transforms
(host side, numpy).

Counterpart of ``dat_segmentation_tpu/data/imagenet.py`` (reference
datasets/imagenet.py): RandomResizedCrop with a bicubic resize, the flip,
timm's RandAugment policy ``rand-m9-mstd0.5-inc1`` (its 15 ops, PIL
semantics), colour jitter, normalisation and random erasing for training;
the 256 bicubic resize and the 224 centre crop for val. The JAX package
makes its resizes and warps through cv2; the port does not depend on cv2
and makes them in its native library (``native/imageops.cpp``:
``resize_cubic_u8``, ``warp_affine_u8``), equal to OpenCV's C++ bit for bit,
and the Sharpness op's 3x3 smoothing in numpy float32 as ``cv2.filter2D``
computes it. Every draw comes from the caller's ``random.Random`` in the
JAX package's order, so one seed gives one item in both packages. JPEG
decode is ``data/image_io.py``'s (Pillow).
"""

from __future__ import annotations

import math
import random
from pathlib import Path

import numpy as np

from .. import native
from .image_io import imread_rgb

IN_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
IN_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def random_resized_crop(img, rng: random.Random, size=224,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = rng.randint(0, h - ch)
            left = rng.randint(0, w - cw)
            crop = img[top: top + ch, left: left + cw]
            return native.resize_cubic_u8(crop, (size, size))
    # centre-crop fallback
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return native.resize_cubic_u8(img[top: top + s, left: left + s], (size, size))


# -- RandAugment: timm's rand-m9-mstd0.5-inc1 policy ----------------------
#
# The 15-op _RAND_TRANSFORMS set, each applied with probability 0.5 at a
# magnitude ~ N(9, 0.5) clipped to [0, 10], the 'increasing' argument
# mappings, a random sign on the signed ops and grey (128) fill for the
# geometric warps. Pixel ops follow PIL (ImageOps / ImageEnhance).

_MAX_LEVEL = 10.0
_FILL = 128
_SMOOTH = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0  # PIL SMOOTH


def _randomly_negate(v, rng):
    return -v if rng.random() > 0.5 else v


def _blend(degenerate, img, factor):
    """PIL Image.blend with extrapolation (ImageEnhance semantics)."""
    out = degenerate.astype(np.float32) + factor * (
        img.astype(np.float32) - degenerate.astype(np.float32)
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def _gray_l(img):
    """PIL convert('L'): ITU-R 601-2 luma, truncated to int."""
    f = img.astype(np.float32)
    return ((f[..., 0] * 299 + f[..., 1] * 587 + f[..., 2] * 114) / 1000).astype(np.uint8)


def rotation_matrix(center, degrees: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: input -> output, counter-clockwise for
    positive angles, in float64 (the centre taken as float32, as OpenCV's
    ``Point2f``)."""
    angle = degrees * (math.pi / 180)
    a, b = math.cos(angle) * scale, math.sin(angle) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[a, b, (1 - a) * cx - b * cy], [-b, a, b * cx + (1 - a) * cy]])


def _warp(img, mtx):
    """PIL Image.transform(AFFINE): ``mtx`` maps output to input, the border
    is filled grey."""
    return native.warp_affine_u8(img, mtx, _FILL)


def _op_autocontrast(img, level, rng):
    out = np.empty_like(img)
    for c in range(3):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            out[..., c] = ch
        else:
            scale = 255.0 / (hi - lo)
            out[..., c] = np.clip((ch.astype(np.float32) - lo) * scale + 0.5, 0, 255).astype(np.uint8)
    return out


def _op_equalize(img, level, rng):
    """PIL ImageOps.equalize's LUT, per channel."""
    out = np.empty_like(img)
    for c in range(3):
        ch = img[..., c]
        h = np.bincount(ch.ravel(), minlength=256)
        nonzero = h[h != 0]
        if len(nonzero) <= 1:
            out[..., c] = ch
            continue
        step = (int(h.sum()) - int(nonzero[-1])) // 255
        if step == 0:
            out[..., c] = ch
            continue
        n = step // 2
        lut = np.empty(256, np.int64)
        for i in range(256):
            lut[i] = n // step
            n += int(h[i])
        out[..., c] = np.clip(lut, 0, 255).astype(np.uint8)[ch]
    return out


def _op_invert(img, level, rng):
    return (255 - img).astype(np.uint8)


def _op_rotate(img, level, rng):
    deg = _randomly_negate(level / _MAX_LEVEL * 30.0, rng)
    m = rotation_matrix(((img.shape[1] - 1) / 2, (img.shape[0] - 1) / 2), deg, 1.0)
    return native.warp_affine_u8(img, m, _FILL, inverse_map=False)


def _op_posterize_inc(img, level, rng):
    bits = 4 - int(level / _MAX_LEVEL * 4)
    if bits >= 8:
        return img
    mask = np.uint8(255 & ~((1 << (8 - bits)) - 1)) if bits > 0 else np.uint8(0)
    return (img & mask).astype(np.uint8)


def _op_solarize_inc(img, level, rng):
    thresh = 256 - int(level / _MAX_LEVEL * 256)
    return np.where(img >= thresh, 255 - img, img).astype(np.uint8)


def _op_solarize_add(img, level, rng):
    add = int(level / _MAX_LEVEL * 110)
    bumped = np.clip(img.astype(np.int32) + add, 0, 255).astype(np.uint8)
    return np.where(img < 128, bumped, img)


def _enhance_factor(level, rng):
    # timm _enhance_increasing_level_to_arg
    v = level / _MAX_LEVEL * 0.9
    return max(0.1, 1.0 + _randomly_negate(v, rng))


def _op_color(img, level, rng):
    degenerate = np.repeat(_gray_l(img)[..., None], 3, axis=-1)
    return _blend(degenerate, img, _enhance_factor(level, rng))


def _op_contrast(img, level, rng):
    mean = int(float(_gray_l(img).mean()) + 0.5)
    return _blend(np.full_like(img, mean), img, _enhance_factor(level, rng))


def _op_brightness(img, level, rng):
    return _blend(np.zeros_like(img), img, _enhance_factor(level, rng))


def smooth3x3(img: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, _SMOOTH, borderType=BORDER_REPLICATE)`` of a
    uint8 image: the 9 taps summed in float32 in row-major order, rounded
    half to even."""
    h, w = img.shape[:2]
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge").astype(np.float32)
    acc = np.zeros(img.shape, np.float32)
    for i in range(3):
        for j in range(3):
            acc += pad[i: i + h, j: j + w] * _SMOOTH[i, j]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def _op_sharpness(img, level, rng):
    smooth = smooth3x3(img)
    # PIL keeps the 1 px border unfiltered
    smooth[0, :] = img[0, :]
    smooth[-1, :] = img[-1, :]
    smooth[:, 0] = img[:, 0]
    smooth[:, -1] = img[:, -1]
    return _blend(smooth, img, _enhance_factor(level, rng))


def _op_shear_x(img, level, rng):
    s = _randomly_negate(level / _MAX_LEVEL * 0.3, rng)
    return _warp(img, [[1, s, 0], [0, 1, 0]])


def _op_shear_y(img, level, rng):
    s = _randomly_negate(level / _MAX_LEVEL * 0.3, rng)
    return _warp(img, [[1, 0, 0], [s, 1, 0]])


def _op_translate_x_rel(img, level, rng):
    p = _randomly_negate(level / _MAX_LEVEL * 0.45, rng) * img.shape[1]
    return _warp(img, [[1, 0, p], [0, 1, 0]])


def _op_translate_y_rel(img, level, rng):
    p = _randomly_negate(level / _MAX_LEVEL * 0.45, rng) * img.shape[0]
    return _warp(img, [[1, 0, 0], [0, 1, p]])


# timm _RAND_TRANSFORMS order (rand_augment_ops with increasing=True)
RAND_AUGMENT_OPS = {
    "AutoContrast": _op_autocontrast,
    "Equalize": _op_equalize,
    "Invert": _op_invert,
    "Rotate": _op_rotate,
    "Posterize": _op_posterize_inc,
    "Solarize": _op_solarize_inc,
    "SolarizeAdd": _op_solarize_add,
    "Color": _op_color,
    "Contrast": _op_contrast,
    "Brightness": _op_brightness,
    "Sharpness": _op_sharpness,
    "ShearX": _op_shear_x,
    "ShearY": _op_shear_y,
    "TranslateXRel": _op_translate_x_rel,
    "TranslateYRel": _op_translate_y_rel,
}


def rand_augment(img, rng: random.Random, *, n=2, magnitude=9, mstd=0.5, prob=0.5):
    """Apply ``n`` randomly chosen ops, each with probability ``prob`` and
    magnitude ~ N(magnitude, mstd) clipped to [0, 10] (timm AugmentOp)."""
    ops = list(RAND_AUGMENT_OPS.values())
    for _ in range(n):
        op = ops[rng.randint(0, len(ops) - 1)]
        if prob < 1.0 and rng.random() > prob:
            continue
        level = magnitude
        if mstd > 0:
            level = rng.gauss(magnitude, mstd)
        level = max(0.0, min(_MAX_LEVEL, level))
        img = op(img, level, rng)
    return img


def color_jitter(img, rng: random.Random, strength: float = 0.4):
    """With probability 0.8, scale every value by 1 + U(-strength,
    strength)."""
    if strength and rng.random() < 0.8:
        f = 1.0 + rng.uniform(-strength, strength)
        img = np.clip(img.astype(np.float32) * f, 0, 255).astype(np.uint8)
    return img


def random_erasing(img, rng: random.Random, *, p=0.25, scale=(0.02, 1 / 3)):
    """With probability ``p``, overwrite a box of the float32 image, in
    place, with normal noise seeded from ``rng``."""
    if rng.random() >= p:
        return img
    h, w = img.shape[:2]
    area = rng.uniform(*scale) * h * w
    ar = np.exp(rng.uniform(np.log(0.3), np.log(1 / 0.3)))
    eh = int(round(np.sqrt(area / ar)))
    ew = int(round(np.sqrt(area * ar)))
    if eh < h and ew < w:
        top = rng.randint(0, h - eh)
        left = rng.randint(0, w - ew)
        noise = np.random.RandomState(rng.randint(0, 2**31 - 1)).randn(eh, ew, 3)
        img[top: top + eh, left: left + ew] = noise
    return img


def normalize(img):
    return (img.astype(np.float32) - IN_MEAN) / IN_STD


def train_transform_cls(img, rng: random.Random, *, size=224, color_jitter_strength=0.4):
    """RandomResizedCrop, flip, RandAugment, colour jitter, normalise,
    random erasing: (size, size, 3) float32."""
    img = random_resized_crop(img, rng, size)
    if rng.random() < 0.5:
        img = np.ascontiguousarray(img[:, ::-1])
    img = rand_augment(img, rng)
    img = color_jitter(img, rng, color_jitter_strength)
    out = random_erasing(normalize(img), rng)
    return out.astype(np.float32)


def val_transform_cls(img, *, size=224, crop_pct=0.875):
    """Bicubic resize of the short side to size / crop_pct, centre crop,
    normalise: (size, size, 3) float32."""
    h, w = img.shape[:2]
    scale_size = int(size / crop_pct)
    f = scale_size / min(h, w)
    img = native.resize_cubic_u8(img, (int(w * f + 0.5), int(h * f + 0.5)))
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    img = img[top: top + size, left: left + size]
    return normalize(img).astype(np.float32)


class ImageNetDataset:
    """``<root>/<split>/<class_dir>/*.JPEG`` (reference
    datasets/imagenet.py:39-61): classes are the sorted directory names, and
    a train item's augmentation draws from
    ``random.Random(f"{seed}:{epoch}:{idx}")``."""

    def __init__(self, root: str, split: str = "train", *, size: int = 224, seed: int = 0):
        self.root = Path(root) / split
        if not self.root.exists():
            raise FileNotFoundError(self.root)
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for p in sorted((self.root / c).iterdir()):
                if p.suffix.lower() in (".jpeg", ".jpg", ".png"):
                    self.samples.append((p, self.class_to_idx[c]))
        self.is_train = split == "train"
        self.size = size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream: a train item's RNG is keyed by
        (seed, epoch, idx)."""
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = imread_rgb(path)
        if self.is_train:
            rng = random.Random(f"{self.seed}:{self.epoch}:{idx}")
            img = train_transform_cls(img, rng, size=self.size)
        else:
            img = val_transform_cls(img, size=self.size)
        return {"image": img, "label": np.int32(label)}
