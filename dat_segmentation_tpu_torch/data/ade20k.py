"""ADE20K data for the port: file discovery, decoding, the label reduction,
the train transform and the val transform, on the host.

The port's own copy of ``dat_segmentation_tpu/data/ade20k.py`` (it imports
nothing of the JAX package): the class names and palette (``:44``,
``:70``), ``resize`` (``:119``), ``pad_to_size`` (``:137``),
``random_crop`` (``:150``), ``reduce_zero_label`` (``:215``),
``train_transform`` (``:223``), ``val_transform`` (``:266``) and
``ADE20KDataset`` (``:283``) with its two layouts, ``set_epoch``, ``load_raw``
and the per-item train RNG ``random.Random(f"{seed}:{epoch}:{idx}")``.
Decoding is ``image_io``'s (Pillow for JPEG, its own PNG reader), not
cv2's; the image resize is cv2's uint8 ``INTER_LINEAR`` in integer PyTorch
ops (``ops/interpolate.py:resize_uint8_linear``) and the mask's cv2's
``INTER_NEAREST``, as ``resize`` does with cv2.

The train transform is the JAX package's native branch (``:240-259``, taken
there with ``DAT_TPU_NATIVE=1``): the photometric distortion, the
normalisation and the pad run in the port's copy of its C++ library
(``native/``), and the draws come in its order, brightness, mode,
contrast, saturation, hue. The JAX package's cv2 branch
(``photometric_distortion``, ``:176``) draws the contrast after the hue
when the mode is 0, so from one seed it gives other augmentations; the
port does not reproduce it.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from .. import native
from ..ops.interpolate import resize_uint8_linear
from .image_io import imread_gray, imread_rgb

# ImageNet mean and std in RGB order
IMG_NORM_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
IMG_NORM_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)

CROP_SIZE = (512, 512)  # (W, H)
IMG_SCALE = (2048, 512)  # (W, H) of the ADE20K test pipeline
CAT_MAX_RATIO = 0.75  # RandomCrop's limit on one class's share of a crop
NUM_ATTEMPTS = 10  # crops drawn before the last one stands

ADE20K_NUM_CLASSES = 150

# Canonical 150-class names + color palette (the mmseg ADE20KDataset
# CLASSES/PALETTE the reference ships inside checkpoint meta).
ADE20K_CLASSES = (
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed ",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper", "fireplace",
    "refrigerator", "grandstand", "path", "stairs", "runway", "case",
    "pool table", "pillow", "screen door", "stairway", "river", "bridge",
    "bookcase", "blind", "coffee table", "toilet", "flower", "book", "hill",
    "bench", "countertop", "stove", "palm", "kitchen island", "computer",
    "swivel chair", "boat", "bar", "arcade machine", "hovel", "bus", "towel",
    "light", "truck", "tower", "chandelier", "awning", "streetlight",
    "booth", "television receiver", "airplane", "dirt track", "apparel",
    "pole", "land", "bannister", "escalator", "ottoman", "bottle", "buffet",
    "poster", "stage", "van", "ship", "fountain", "conveyer belt", "canopy",
    "washer", "plaything", "swimming pool", "stool", "barrel", "basket",
    "waterfall", "tent", "bag", "minibike", "cradle", "oven", "ball", "food",
    "step", "tank", "trade name", "microwave", "pot", "animal", "bicycle",
    "lake", "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce",
    "vase", "traffic light", "tray", "ashcan", "fan", "pier", "crt screen",
    "plate", "monitor", "bulletin board", "shower", "radiator", "glass",
    "clock", "flag",
)

ADE20K_PALETTE = (
    (120, 120, 120), (180, 120, 120), (6, 230, 230), (80, 50, 50),
    (4, 200, 3), (120, 120, 80), (140, 140, 140), (204, 5, 255),
    (230, 230, 230), (4, 250, 7), (224, 5, 255), (235, 255, 7),
    (150, 5, 61), (120, 120, 70), (8, 255, 51), (255, 6, 82),
    (143, 255, 140), (204, 255, 4), (255, 51, 7), (204, 70, 3),
    (0, 102, 200), (61, 230, 250), (255, 6, 51), (11, 102, 255),
    (255, 7, 71), (255, 9, 224), (9, 7, 230), (220, 220, 220),
    (255, 9, 92), (112, 9, 255), (8, 255, 214), (7, 255, 224),
    (255, 184, 6), (10, 255, 71), (255, 41, 10), (7, 255, 255),
    (224, 255, 8), (102, 8, 255), (255, 61, 6), (255, 194, 7),
    (255, 122, 8), (0, 255, 20), (255, 8, 41), (255, 5, 153),
    (6, 51, 255), (235, 12, 255), (160, 150, 20), (0, 163, 255),
    (140, 140, 140), (250, 10, 15), (20, 255, 0), (31, 255, 0),
    (255, 31, 0), (255, 224, 0), (153, 255, 0), (0, 0, 255),
    (255, 71, 0), (0, 235, 255), (0, 173, 255), (31, 0, 255),
    (11, 200, 200), (255, 82, 0), (0, 255, 245), (0, 61, 255),
    (0, 255, 112), (0, 255, 133), (255, 0, 0), (255, 163, 0),
    (255, 102, 0), (194, 255, 0), (0, 143, 255), (51, 255, 0),
    (0, 82, 255), (0, 255, 41), (0, 255, 173), (10, 0, 255),
    (173, 255, 0), (0, 255, 153), (255, 92, 0), (255, 0, 255),
    (255, 0, 245), (255, 0, 102), (255, 173, 0), (255, 0, 20),
    (255, 184, 184), (0, 31, 255), (0, 255, 61), (0, 71, 255),
    (255, 0, 204), (0, 255, 194), (0, 255, 82), (0, 10, 255),
    (0, 112, 255), (51, 0, 255), (0, 194, 255), (0, 122, 255),
    (0, 255, 163), (255, 153, 0), (0, 255, 10), (255, 112, 0),
    (143, 255, 0), (82, 0, 255), (163, 255, 0), (255, 235, 0),
    (8, 184, 170), (133, 0, 255), (0, 255, 92), (184, 0, 255),
    (255, 0, 31), (0, 184, 255), (0, 214, 255), (255, 0, 112),
    (92, 255, 0), (0, 224, 255), (112, 224, 255), (70, 184, 160),
    (163, 0, 255), (153, 0, 255), (71, 255, 0), (255, 0, 163),
    (255, 204, 0), (255, 0, 143), (0, 255, 235), (133, 255, 0),
    (255, 0, 235), (245, 0, 255), (255, 0, 122), (255, 245, 0),
    (10, 190, 212), (214, 255, 0), (0, 204, 255), (20, 0, 255),
    (255, 255, 0), (0, 153, 255), (0, 41, 255), (0, 255, 204),
    (41, 0, 255), (41, 255, 0), (173, 0, 255), (0, 245, 255),
    (71, 0, 255), (122, 0, 255), (0, 255, 184), (0, 92, 255),
    (184, 255, 0), (0, 133, 255), (255, 214, 0), (25, 194, 194),
    (102, 255, 0), (92, 0, 255),
)
assert len(ADE20K_CLASSES) == ADE20K_NUM_CLASSES
assert len(ADE20K_PALETTE) == ADE20K_NUM_CLASSES


def _nearest_index(n_in: int, n_out: int) -> torch.Tensor:
    """cv2's ``INTER_NEAREST`` source index of each output position:
    floor(d * (1 / (n_out / n_in))) in double, clipped to the image."""
    scale = 1.0 / (n_out / n_in)
    d = torch.arange(n_out, dtype=torch.float64)
    return torch.floor(d * scale).to(torch.int64).clamp_(max=n_in - 1)


def resize(img, mask, scale=IMG_SCALE, *, ratio=None, keep_ratio=False):
    """Resize an (H, W, 3) uint8 image bilinearly and its (H, W) mask by
    nearest neighbour to ``scale`` (W, H) times ``ratio`` (each side
    truncated to an integer), or to fit it keeping the aspect ratio."""
    base_w, base_h = scale
    if ratio is not None:
        target_w, target_h = int(base_w * ratio), int(base_h * ratio)
    else:
        target_w, target_h = base_w, base_h
    if keep_ratio:
        h, w = img.shape[:2]
        f = min(target_w / w, target_h / h)
        rw, rh = int(w * f + 0.5), int(h * f + 0.5)
    else:
        rw, rh = target_w, target_h
    img = resize_uint8_linear(torch.from_numpy(np.ascontiguousarray(img)), (rh, rw)).numpy()
    if mask is not None:
        h, w = mask.shape
        mask = mask[_nearest_index(h, rh).numpy()[:, None], _nearest_index(w, rw).numpy()[None, :]]
    return img, mask


def pad_to_size(img, mask, crop_size=CROP_SIZE, ignore_index=255):
    """Pad bottom and right up to ``crop_size`` (W, H): the image with 0,
    the mask with ``ignore_index``."""
    cw, ch = crop_size
    h, w = img.shape[:2]
    ph, pw = max(ch - h, 0), max(cw - w, 0)
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw)) + ((0, 0),) * (img.ndim - 2))
        if mask is not None:
            mask = np.pad(mask, ((0, ph), (0, pw)), constant_values=ignore_index)
    return img, mask


def random_crop(
    img, mask, rng: random.Random, crop_size=CROP_SIZE, *, ignore_index=255,
):
    """A ``crop_size`` (W, H) window at a random place, drawn again (up to
    ``NUM_ATTEMPTS`` times) while one class fills ``CAT_MAX_RATIO`` or more
    of its labelled pixels; the last draw stands. Pads first where the
    image is smaller than the crop."""
    cw, ch = crop_size
    h, w = mask.shape
    if h < ch or w < cw:
        img, mask = pad_to_size(img, mask, crop_size, ignore_index)
        h, w = mask.shape
    img_crop = mask_crop = None
    for _ in range(NUM_ATTEMPTS):
        top = rng.randint(0, h - ch)
        left = rng.randint(0, w - cw)
        img_crop = img[top : top + ch, left : left + cw]
        mask_crop = mask[top : top + ch, left : left + cw]
        valid = mask_crop != ignore_index
        if not valid.any():
            max_ratio = 0.0
        else:
            _, counts = np.unique(mask_crop[valid], return_counts=True)
            max_ratio = counts.max() / counts.sum()
        if max_ratio < CAT_MAX_RATIO:
            break
    return img_crop, mask_crop


def normalize(img, mean=IMG_NORM_MEAN, std=IMG_NORM_STD):
    return (img.astype(np.float32) - mean) / std


def reduce_zero_label(mask, ignore_index=255):
    """0 -> ignore, k -> k-1; the wrapped value (an original 255) -> ignore
    (reference datasets/ade20k.py:103-106)."""
    m = mask.astype(np.int32)
    m = np.where(m == 0, 256, m) - 1
    return np.where(m >= 254, ignore_index, m).astype(np.int32)


def train_transform(
    img, mask, rng: random.Random, *, crop_size=CROP_SIZE,
    img_scale=IMG_SCALE, ratio_range=(0.5, 2.0), ignore_index=255,
):
    """Random scale (``ratio_range`` of ``img_scale``, the aspect ratio not
    kept) -> pad -> random crop -> horizontal flip (p 0.5) -> photometric
    distortion -> normalise -> pad: a float32 (H, W, 3) image and an int32
    mask of ``crop_size`` (W, H). Every draw comes from ``rng``, in the JAX
    native branch's order."""
    ratio = rng.uniform(*ratio_range)
    img, mask = resize(img, mask, img_scale, ratio=ratio)
    if img.shape[0] < crop_size[1] or img.shape[1] < crop_size[0]:
        img, mask = pad_to_size(img, mask, crop_size, ignore_index)
    img, mask = random_crop(img, mask, rng, crop_size, ignore_index=ignore_index)
    img, mask = pad_to_size(img, mask, crop_size, ignore_index)
    if rng.random() < 0.5:
        img = np.ascontiguousarray(img[:, ::-1])
        mask = np.ascontiguousarray(mask[:, ::-1])
    bright = rng.uniform(-32, 32) if rng.random() < 0.5 else 0.0
    mode = rng.randint(0, 1)
    alpha = rng.uniform(0.5, 1.5) if rng.random() < 0.5 else 1.0
    sat = rng.uniform(0.5, 1.5) if rng.random() < 0.5 else 1.0
    hue = rng.uniform(-18, 18) if rng.random() < 0.5 else 0.0
    img = native.photometric_distortion_u8(
        img.astype(np.uint8), brightness=bright, contrast=alpha, saturation=sat, hue=hue,
        contrast_first=(mode == 1),
    )
    img = native.normalize_pad_f32(img, IMG_NORM_MEAN, IMG_NORM_STD, crop_size[1], crop_size[0])
    _, mask = pad_to_size(np.zeros_like(mask, np.uint8), mask, crop_size, ignore_index)
    return img, mask.astype(np.int32)


def val_transform(
    img, mask, *, crop_size=CROP_SIZE, img_scale=IMG_SCALE,
    keep_ratio=False, ignore_index=255,
):
    """resize -> normalize -> pad: float32 (H, W, 3) image, int32 mask."""
    img, mask = resize(img, mask, img_scale, keep_ratio=keep_ratio)
    img = normalize(img)
    img, mask = pad_to_size(img, mask, crop_size, ignore_index)
    if mask is None:
        return img.astype(np.float32), None
    return img.astype(np.float32), mask.astype(np.int32)


class ADE20KDataset:
    """File discovery and per-item decode and transform of ADE20K.

    Two layouts, as the reference: ``images/<split>`` beside
    ``annotations/<split>`` (``split`` named ``training`` or
    ``validation``), or ``<split>/img`` beside ``<split>/annotations``.
    Images are every ``*.jpg`` below the image directory, sorted; each mask
    is ``<stem>.png`` in the annotation directory. A train item's
    augmentation draws from ``random.Random(f"{seed}:{epoch}:{idx}")``.
    """

    CLASSES = ADE20K_CLASSES
    PALETTE = ADE20K_PALETTE

    def __init__(
        self,
        root: str,
        split: str = "val",
        *,
        crop_size: Tuple[int, int] = CROP_SIZE,
        ignore_index: int = 255,
        keep_ratio_val: bool = False,
        seed: int = 0,
    ):
        if split not in {"train", "training", "val", "validation", "test"}:
            raise ValueError(f"split {split!r}")
        self.root = Path(root)
        split_dir = {
            "train": "training", "training": "training",
            "val": "validation", "validation": "validation",
            "test": "validation",
        }[split]
        img_dir = self.root / "images" / split_dir
        ann_dir = self.root / "annotations" / split_dir
        if not img_dir.exists() or not ann_dir.exists():
            alt = self.root / split
            if (alt / "img").exists() and (alt / "annotations").exists():
                img_dir, ann_dir = alt / "img", alt / "annotations"
        if not img_dir.exists() or not ann_dir.exists():
            raise FileNotFoundError(
                f"ADE20K layout not found under {self.root} "
                f"(tried images/{split_dir} and {split}/img)"
            )
        self.images = sorted(img_dir.rglob("*.jpg"))
        self.masks = [ann_dir / (p.stem + ".png") for p in self.images]
        self.is_train = split in {"train", "training"}
        self.crop_size = crop_size
        self.ignore_index = ignore_index
        self.keep_ratio_val = keep_ratio_val
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream: a train item's RNG is keyed by
        (seed, epoch, idx), so a run is reproducible and each epoch draws
        afresh. A caller that iterates the dataset over epochs must advance
        it (this method, or ``DataLoader``'s ``epoch=`` or
        ``infinite=True``), or every epoch repeats the first's draws."""
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.images)

    def load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(H, W, 3) uint8 RGB image and its (H, W) int32 mask after
        ``reduce_zero_label``, both at the original size."""
        img = imread_rgb(self.images[idx])
        mask = imread_gray(self.masks[idx])
        return img, reduce_zero_label(mask, self.ignore_index)

    def __getitem__(self, idx: int) -> dict:
        img, mask = self.load_raw(idx)
        if self.is_train:
            rng = random.Random(f"{self.seed}:{self.epoch}:{idx}")
            img, mask = train_transform(
                img, mask, rng, crop_size=self.crop_size, ignore_index=self.ignore_index,
            )
        else:
            img, mask = val_transform(
                img, mask, crop_size=self.crop_size, keep_ratio=self.keep_ratio_val,
                ignore_index=self.ignore_index,
            )
        return {"image": img, "label": mask, "path": str(self.images[idx])}
