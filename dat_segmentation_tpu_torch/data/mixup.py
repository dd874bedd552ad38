"""Mixup and CutMix of a classifier batch (timm's defaults).

Counterpart of ``dat_segmentation_tpu/data/mixup.py`` (reference
datasets/imagenet.py:16-36): Mixup (alpha 0.8) or CutMix (alpha 1.0),
switch probability 0.5, label smoothing 0.1, one lambda a batch, each image
paired with its mirror in the flipped (global) batch, and CutMix's lambda corrected
by the box's area after clipping.

The draws are split from their application. ``MixupSampler`` draws the
five scalars of a batch on the host from a ``numpy.random.Generator``
(``torch.distributions.Beta`` takes no ``torch.Generator``): no device
sync, and the generator's state goes into a checkpoint, so a resumed run
draws what the run it continues would have drawn. ``mixup_cutmix`` forms
the images and soft targets on the images' device from the draws, with the
JAX package's float32 arithmetic. The JAX package draws from a JAX key
inside the step; a test replays those draws through ``MixupDraws``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import mirror_rows
from ..parallel.spatial import Rows


MIXUP_ALPHA, CUTMIX_ALPHA, SWITCH_PROB = 0.8, 1.0, 0.5
LABEL_SMOOTHING = 0.1


@dataclass(frozen=True)
class MixupDraws:
    """One batch's draws: CutMix or Mixup, each branch's lambda, and the
    box centre (row, column) on an (H, W) image."""

    use_cutmix: bool
    lam_mix: float
    lam_cut: float
    cy: int
    cx: int


class MixupSampler:
    """The draws of successive batches from ``numpy.random.default_rng(seed)``."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def draw(self, h: int, w: int) -> MixupDraws:
        r = self.rng
        return MixupDraws(
            use_cutmix=bool(r.random() < SWITCH_PROB),
            lam_mix=float(np.float32(r.beta(MIXUP_ALPHA, MIXUP_ALPHA))),
            lam_cut=float(np.float32(r.beta(CUTMIX_ALPHA, CUTMIX_ALPHA))),
            cy=int(r.integers(0, h)),
            cx=int(r.integers(0, w)),
        )

    def get_state(self) -> dict:
        return self.rng.bit_generator.state

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state


def cutmix_box(h: int, w: int, lam: float, cy: int, cx: int) -> Tuple[int, int, int, int]:
    """(y1, y2, x1, x2): a box of area ratio about 1 - lam centred at
    (cy, cx), clipped to the image (the JAX ``_rand_bbox``, its float32
    products truncated)."""
    cut = np.sqrt(np.float32(1) - np.float32(lam))
    ch, cw = int(np.float32(h) * cut), int(np.float32(w) * cut)
    y1, y2 = min(max(cy - ch // 2, 0), h), min(max(cy + ch // 2, 0), h)
    x1, x2 = min(max(cx - cw // 2, 0), w), min(max(cx + cw // 2, 0), w)
    return y1, y2, x1, x2


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return torch.nn.functional.one_hot(labels.long(), num_classes).float() * (on - off) + off


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor, draws: MixupDraws, *,
                 num_classes: int, rows: Optional[Rows] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mixed images in ``images``' dtype, float32 soft targets
    (B, num_classes)) for NHWC ``images`` and integer ``labels`` (B,).
    Inside a process group the pairs are the global batch's: this
    process's rows with their mirrors on data coordinate X-1-d (an
    all-gather of the images and labels over the data group). On a row
    shard of the images (``rows``) the box is the whole image's, and
    this shard takes its rows of it (its mirror is the same spatial peer's
    shard)."""
    _, h, w, _ = images.shape
    lo, H = (0, h) if rows is None else (rows.lo, rows.H)
    flipped = mirror_rows(images)
    if draws.use_cutmix:
        y1, y2, x1, x2 = cutmix_box(H, w, draws.lam_cut, draws.cy, draws.cx)
        out = images.clone()
        a, b = min(max(y1 - lo, 0), h), min(max(y2 - lo, 0), h)
        out[:, a:b, x1:x2] = flipped[:, a:b, x1:x2]
        lam = np.float32(1) - np.float32((y2 - y1) * (x2 - x1)) / np.float32(H * w)
    else:
        lam = np.float32(draws.lam_mix)
        rest = float(np.float32(1) - lam)
        out = (images.float() * float(lam) + flipped.float() * rest).to(images.dtype)
    t1 = one_hot_smooth(labels, num_classes, LABEL_SMOOTHING)
    t2 = one_hot_smooth(mirror_rows(labels), num_classes, LABEL_SMOOTHING)
    targets = t1 * float(lam) + t2 * float(np.float32(1) - np.float32(lam))
    return out, targets
