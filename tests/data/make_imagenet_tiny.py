#!/usr/bin/env python
"""Write ``tests/data/imagenet_tiny``, a small ImageNet-layout folder set.

    python tests/data/make_imagenet_tiny.py

Needs cv2 and numpy; everything is drawn from a numpy seed, so a second
run writes the same arrays (the JPEG bytes are cv2's encoder's, quality
90). Three classes (``n000``, ``n001``, ``n002``), each with four train
and two val JPEGs (``<split>/<class>/<name>.JPEG``) of 96-320 px a side,
none square, with smooth content (sinusoids and Gaussian blobs tinted per
class) so that the files stay small.
"""

from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parent / "imagenet_tiny"
SEED = 0
CLASSES = ("n000", "n001", "n002")
COUNTS = {"train": 4, "val": 2}


def smooth_image(rng, h, w, tint):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.5, 4.0, 2)
        img[..., c] = tint[c] + 50 * np.sin(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6.3))
    for _ in range(5):
        cy, cx = rng.uniform(0, h / max(h, w)), rng.uniform(0, w / max(h, w))
        s = rng.uniform(0.04, 0.2)
        bump = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        img += bump[..., None] * rng.uniform(-80, 80, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    rng = np.random.RandomState(SEED)
    for split, count in COUNTS.items():
        for k, cls in enumerate(CLASSES):
            d = ROOT / split / cls
            d.mkdir(parents=True, exist_ok=True)
            tint = 128 + 40 * np.eye(3)[k]
            for i in range(count):
                while True:
                    h, w = (int(v) for v in rng.randint(96, 321, 2))
                    if h != w:
                        break
                img = smooth_image(rng, h, w, tint)
                cv2.imwrite(str(d / f"{cls}_{i:02d}.JPEG"), img[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, 90])


if __name__ == "__main__":
    main()
