"""Bilinear / nearest resize and average pooling on NHWC tensors.

Counterpart of ``dat_segmentation_tpu/ops/interpolate.py``. The JAX
package wrote these as separable matmuls for the TPU's matrix unit; on the
card they are the PyTorch functionals the reference used
(``F.interpolate``, ``F.avg_pool2d``, ``F.adaptive_avg_pool2d``), applied
to an NCHW view of the NHWC tensor (channels-last memory, no copy).
``resize_uint8_linear`` is cv2's fixed-point ``INTER_LINEAR`` resize of a
uint8 image (the JAX package's test-time resizes), in integer PyTorch ops.

On a row shard (``rows``, the mesh's spatial axis: ``parallel/
spatial.py``) the resizes fetch the source rows their output rows read
and interpolate them (``_rows_resize``); the output is the row shard of
the output's height. ``adaptive_avg_pool`` takes every row (the callers
gather them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import spatial
from ..parallel.spatial import Rows


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _linear_src(n_in: int, n_out: int, lo: int, hi: int, align_corners: bool):
    """``F.interpolate``'s bilinear source taps of output indices [lo, hi)
    along one axis: (i0, i1, the weight of i1), in float64."""
    d = torch.arange(lo, hi, dtype=torch.float64)
    if align_corners:
        src = d * ((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
    else:
        src = ((d + 0.5) * (n_in / n_out) - 0.5).clamp_min(0.0)
    i0 = src.floor().clamp_max(n_in - 1)
    lam = (src - i0).clamp(0.0, 1.0)
    i0 = i0.long()
    return i0, (i0 + 1).clamp_max(n_in - 1), lam


def _nearest_src(n_in: int, n_out: int, lo: int, hi: int) -> torch.Tensor:
    """``F.interpolate(mode='nearest')``'s source indices of output indices
    [lo, hi): floor(d · n_in / n_out) in float32, the last row at most."""
    d = torch.arange(lo, hi, dtype=torch.float32)
    return (d * torch.tensor(n_in / n_out, dtype=torch.float32)).floor().long().clamp_max(
        n_in - 1)


def _lerp(x: torch.Tensor, dim: int, i0, i1, lam) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[dim] = -1
    w = lam.to(x.device, x.dtype).view(shape)
    a = x.index_select(dim, i0.to(x.device))
    b = x.index_select(dim, i1.to(x.device))
    return a + (b - a) * w


def _span_of(idx: torch.Tensor) -> Tuple[int, int]:
    return (int(idx.min()), int(idx.max()) + 1) if idx.numel() else (0, 0)


def _rows_resize(x: torch.Tensor, rows: Rows, out_hw: Tuple[int, int], taps,
                 mode: str, align_corners: Optional[bool]) -> torch.Tensor:
    """The output rows this peer holds of a resize of the row shard ``x``.
    An upsample by a whole factor k (``align_corners`` False) is
    ``F.interpolate`` of the source rows with one more on each side: its
    source coordinates are the same shifted by whole rows, so the kept rows
    are the one-process values exactly. Any other is separable:
    ``taps(n_in, n_out, lo, hi)`` gives an axis's source indices (and
    weights, None for nearest) of output indices [lo, hi)."""
    H_out, W_out = out_hw
    out = rows.at(H_out)
    k = H_out // rows.H
    if k * rows.H == H_out and not align_corners:
        def want(s):
            lo, hi = out.span(s)
            a = max(lo // k - 1, 0)
            return a, max(min(-(-hi // k) + 1, rows.H), a + 1)

        a = want(rows.axis.rank)[0]
        xs = spatial.fetch(x, rows, want)
        y = F.interpolate(_nchw(xs), size=(xs.shape[1] * k, W_out), mode=mode,
                          align_corners=align_corners)
        return _nhwc(y)[:, out.lo - a * k:out.hi - a * k].contiguous()

    def need(s):
        lo, hi = out.span(s)
        idx = taps(rows.H, H_out, lo, hi)
        return _span_of(torch.cat([idx[0], idx[1]]))

    a = need(rows.axis.rank)[0]
    xs = spatial.fetch(x, rows, need)
    i0, i1, lam = taps(rows.H, H_out, out.lo, out.hi)
    y = _lerp(xs, 1, i0 - a, i1 - a, lam) if lam is not None else xs.index_select(
        1, (i0 - a).to(x.device))
    if x.shape[2] != W_out:
        j0, j1, lam = taps(x.shape[2], W_out, 0, W_out)
        y = _lerp(y, 2, j0, j1, lam) if lam is not None else y.index_select(2, j0.to(x.device))
    return y


def resize_bilinear(
    x: torch.Tensor, out_hw: Tuple[int, int], *, align_corners: bool = False,
    rows: Optional[Rows] = None,
) -> torch.Tensor:
    """``F.interpolate(mode='bilinear')`` of an NHWC tensor to ``out_hw``;
    of a row shard on ``rows``, its rows of the output (H global)."""
    if rows is not None:
        if (rows.H, x.shape[2]) == tuple(out_hw):
            return x
        return _rows_resize(x, rows, out_hw, lambda n_in, n_out, lo, hi: _linear_src(
            n_in, n_out, lo, hi, align_corners), "bilinear", align_corners)
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(
        _nchw(x), size=tuple(out_hw), mode="bilinear", align_corners=align_corners
    )
    return _nhwc(y)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int],
                   rows: Optional[Rows] = None) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` of an NHWC tensor (the FPN neck's
    top-down path); of a row shard on ``rows``, its rows of the output."""
    if rows is not None:
        if (rows.H, x.shape[2]) == tuple(out_hw):
            return x
        return _rows_resize(x, rows, out_hw, lambda n_in, n_out, lo, hi: (
            _nearest_src(n_in, n_out, lo, hi),) * 2 + (None,), "nearest", None)
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
