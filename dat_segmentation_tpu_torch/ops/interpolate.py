"""Bilinear / nearest resize and average pooling on NHWC tensors.

Counterpart of ``dat_segmentation_tpu/ops/interpolate.py``. The JAX
package wrote these as separable matmuls for the TPU's matrix unit; on the
card they are the PyTorch functionals the reference used
(``F.interpolate``, ``F.avg_pool2d``, ``F.adaptive_avg_pool2d``), applied
to an NCHW view of the NHWC tensor (channels-last memory, no copy).
``resize_uint8_linear`` is cv2's fixed-point ``INTER_LINEAR`` resize of a
uint8 image (the JAX package's test-time resizes), in integer PyTorch ops.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resize_bilinear(
    x: torch.Tensor, out_hw: Tuple[int, int], *, align_corners: bool = False
) -> torch.Tensor:
    """``F.interpolate(mode='bilinear')`` of an NHWC tensor to ``out_hw``."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(
        _nchw(x), size=tuple(out_hw), mode="bilinear", align_corners=align_corners
    )
    return _nhwc(y)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` of an NHWC tensor (the FPN neck's
    top-down path)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return _nhwc(F.interpolate(_nchw(x), size=tuple(out_hw), mode="nearest"))


def avg_pool(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Average pool without padding (NHWC)."""
    return _nhwc(F.avg_pool2d(_nchw(x), kernel, stride))


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d(out_hw)`` of an NHWC tensor."""
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), tuple(out_hw)))


COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS


def _linear_taps(n_in: int, n_out: int):
    """cv2's source indices and 11-bit weights of one axis of a uint8
    ``INTER_LINEAR`` resize: f = (d + 0.5) * n_in / n_out - 0.5 in double,
    rounded to float; s = floor(f); the weights round((1 - frac) * 2048)
    and round(frac * 2048) from float, ties to even. The indices s and
    s + 1 are clipped to the image; the weights are not clamped."""
    d = torch.arange(n_out, dtype=torch.float64)
    f = ((d + 0.5) * (n_in / n_out) - 0.5).to(torch.float32)
    s = torch.floor(f)
    frac = f - s
    one = float(1 << COEF_BITS)
    w0 = torch.round((1.0 - frac) * one).to(torch.int32)
    w1 = torch.round(frac * one).to(torch.int32)
    s = s.to(torch.int64)
    return s.clamp(0, n_in - 1), (s + 1).clamp(0, n_in - 1), w0, w1


def resize_uint8_linear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) of an
    (H, W, C) uint8 image, bit for bit, on img's device.

    cv2 resizes uint8 in two fixed-point passes: a horizontal one into
    int (weights summing to about 2^11), then a vertical one that keeps
    the high halves of 16-bit products, as its vector code does,
    ((b0 (r0 >> 4)) >> 16) + ((b1 (r1 >> 4)) >> 16), and rounds off the
    last two bits. Every step is exact in int32.
    """
    if img.dtype != torch.uint8 or img.ndim != 3:
        raise ValueError(f"resize_uint8_linear: (H, W, C) uint8, got {tuple(img.shape)} "
                         f"{img.dtype}")
    (h, w), (oh, ow) = img.shape[:2], tuple(out_hw)
    dev = img.device
    sx0, sx1, a0, a1 = (t.to(dev) for t in _linear_taps(w, ow))
    sy0, sy1, b0, b1 = (t.to(dev) for t in _linear_taps(h, oh))
    x = img.to(torch.int32)
    rows = x[:, sx0] * a0[None, :, None] + x[:, sx1] * a1[None, :, None]  # (h, ow, C)
    r0, r1 = rows[sy0] >> 4, rows[sy1] >> 4
    out = ((b0[:, None, None] * r0) >> 16) + ((b1[:, None, None] * r1) >> 16)
    return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)
