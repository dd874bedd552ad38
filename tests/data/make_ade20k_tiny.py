#!/usr/bin/env python
"""Write ``tests/data/ade20k_tiny``, a six-image ADE20K-layout val set, and
the reference decodes its readers are held to.

    python tests/data/make_ade20k_tiny.py

Needs cv2 and numpy; everything is drawn from a numpy seed, so a second
run writes the same arrays (the JPEG bytes are cv2's encoder's).

* ``images/validation/*.jpg``: six images at ADE20K's usual shapes, the
  first two 512x512 (batched eval; a TTA test on the first two compiles
  the JAX package's programs for one shape only), with
  smooth content (sinusoids and Gaussian blobs) so that the JPEGs stay
  small; cv2's default quality (95) and chroma subsampling (4:2:0).
* ``annotations/validation/*.png``: 8-bit greyscale masks of Voronoi
  regions labelled 0-150, 0 (``reduce_zero_label``'s ignore) included.
* ``cv2_digests.json``: the SHA-256 and shape of cv2's decode of each
  image (``imread(IMREAD_COLOR)`` then ``BGR2RGB``) and mask
  (``imread(IMREAD_GRAYSCALE)``); the decodes themselves would be about
  4 MB even compressed.
* ``decode/``: three small JPEGs (colour 120x160, colour 97x131, grey
  96x128) with sharp edges and noise, each beside cv2's decode as an
  ``.npz`` (``rgb``), which a JPEG reader is held to pixel by pixel.
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parent / "ade20k_tiny"
SEED = 0
SHAPES = [(512, 512), (512, 512), (512, 683), (683, 512), (384, 512), (512, 768)]  # (H, W)
DECODE = {"colour_120x160": (120, 160, 3), "odd_97x131": (97, 131, 3), "grey_96x128": (96, 128)}


def smooth_image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.5, 3.0, 2)
        img[..., c] = 128 + 50 * np.sin(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6.3))
    for _ in range(6):
        cy, cx = rng.uniform(0, h / max(h, w)), rng.uniform(0, w / max(h, w))
        s = rng.uniform(0.04, 0.15)
        bump = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        img += bump[..., None] * rng.uniform(-70, 70, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def voronoi_mask(rng, h, w, regions=16):
    seeds = rng.uniform(0, 1, (regions, 2)) * (h, w)
    labels = rng.randint(1, 151, regions)
    labels[0] = 0  # ignored after reduce_zero_label
    yy, xx = np.mgrid[0:h, 0:w]
    d = (yy[..., None] - seeds[:, 0]) ** 2 + (xx[..., None] - seeds[:, 1]) ** 2
    return labels[d.argmin(-1)].astype(np.uint8)


def sharp_image(rng, shape):
    h, w = shape[:2]
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(8):  # colour rectangles: edges where 4:2:0 chroma is upsampled
        y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
        img[y0 : y0 + rng.randint(4, h // 2), x0 : x0 + rng.randint(4, w // 2)] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 12, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if len(shape) == 2 else img


def digest(a):
    return {"shape": list(a.shape), "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}


def main():
    rng = np.random.RandomState(SEED)
    img_dir = ROOT / "images" / "validation"
    ann_dir = ROOT / "annotations" / "validation"
    dec_dir = ROOT / "decode"
    for d in (img_dir, ann_dir, dec_dir):
        d.mkdir(parents=True, exist_ok=True)
    digests = {"images": {}, "masks": {}}
    for i, (h, w) in enumerate(SHAPES, 1):
        stem = f"ADE_val_{i:08d}"
        img, mask = smooth_image(rng, h, w), voronoi_mask(rng, h, w)
        cv2.imwrite(str(img_dir / f"{stem}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(ann_dir / f"{stem}.png"), mask)
        rgb = cv2.cvtColor(cv2.imread(str(img_dir / f"{stem}.jpg"), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        grey = cv2.imread(str(ann_dir / f"{stem}.png"), cv2.IMREAD_GRAYSCALE)
        assert (grey == mask).all()
        digests["images"][f"{stem}.jpg"] = digest(rgb)
        digests["masks"][f"{stem}.png"] = digest(grey)
    for name, shape in DECODE.items():
        img = sharp_image(rng, shape)
        path = dec_dir / f"{name}.jpg"
        cv2.imwrite(str(path), img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        rgb = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.savez_compressed(dec_dir / f"{name}.npz", rgb=rgb)
    digests["cv2"] = cv2.__version__
    (ROOT / "cv2_digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
