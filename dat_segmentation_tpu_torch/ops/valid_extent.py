"""Per-sample valid extents for exact padded inference, in PyTorch.

Counterpart of ``dat_segmentation_tpu/ops/valid_extent.py``. A batch of
images of different true sizes, zero-padded to one bucket shape, runs as
one forward whose result on each image's valid region equals what that
image gives alone at its true shape (mmseg's whole mode runs the exact
resized image). Zero padding alone does not: three families of ops see the
padded extent instead of the true one,

  1. spatial convolutions: windows near the true border must read the
     zeros that the exact run's padding gives, and the pad region fills
     with non-zero values again after every bias and LayerNorm;
  2. whatever is normalised over the feature size: the deformable
     attention's reference and query grids, its tanh offset range, the
     bilinear and nearest resize ratios, the adaptive pool's bins;
  3. reductions over the map: the softmax over sampled keys, the PPM's
     pooling.

The design is the JAX package's: an ``ExtentMap`` context maps padded
spatial shapes to per-sample ``(B, 2)`` int32 extents on the device,
seeded with the images' true (h, w) and grown by each conv as data flows
(the conv's own k/s/p arithmetic gives the exact run's shapes, so no
registry of the architecture is needed; the first writer of a shape
keeps it). ``models/layers.py:Conv2d`` consults it: it zeroes its input
and output beyond the extent. The resizes and the pool below are the
per-sample weight-matrix forms of the JAX package (the same matrices,
applied with ``einsum``, so both packages sum the same products), and the
attention masks invalid keys out of its softmax
(``models/deformable_attention.py``).

Only ``EncoderDecoder.forward(valid_hw=...)`` enters the context; training
and the true-shape eval never pay for any of this.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_CTX: contextvars.ContextVar[Optional["ExtentMap"]] = contextvars.ContextVar(
    "dat_torch_valid_extent", default=None)


class ExtentMap:
    """Padded spatial shape -> per-sample valid extent ``(B, 2)`` int32.

    Every tensor at one padded resolution has the same valid extent in
    this architecture (all resolutions derive from the image through the
    same conv arithmetic; the kv grids of all four stages coincide with
    the stage-3 extent, as ``floor((e - 1) / (2s)) + 1`` composes), so one
    dict is unambiguous. Registration keeps the first writer (the
    upstream producer)."""

    def __init__(self, image_hw: Tuple[int, int], valid_hw: torch.Tensor):
        if valid_hw.ndim != 2 or valid_hw.shape[1] != 2:
            raise ValueError(f"valid_hw: (B, 2) true (h, w) a sample, got {tuple(valid_hw.shape)}")
        self._m: Dict[Tuple[int, int], torch.Tensor] = {
            (int(image_hw[0]), int(image_hw[1])): valid_hw.to(torch.int32)}

    def get(self, hw) -> Optional[torch.Tensor]:
        return self._m.get((int(hw[0]), int(hw[1])))

    def register(self, hw, ext: torch.Tensor) -> None:
        self._m.setdefault((int(hw[0]), int(hw[1])), ext)


def current() -> Optional[ExtentMap]:
    return _CTX.get()


def lookup(hw) -> Optional[torch.Tensor]:
    """The extent registered for padded shape ``hw``; None outside exact
    mode or for a shape nothing registered."""
    ctx = _CTX.get()
    return None if ctx is None else ctx.get(hw)


@contextlib.contextmanager
def exact_extent(image_hw: Tuple[int, int], valid_hw: torch.Tensor):
    """Exact padded inference for the enclosed forward."""
    token = _CTX.set(ExtentMap(image_hw, valid_hw))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def suspend():
    """Turn extent masking off for the enclosed ops (ops on fully valid
    small maps, such as the PPM's pooled ones, whose shapes could collide
    with a registered feature map's)."""
    token = _CTX.set(None)
    try:
        yield
    finally:
        _CTX.reset(token)


# ---------------------------------------------------------------------------
# extent arithmetic and masking
# ---------------------------------------------------------------------------


def conv_out_extent(ext: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """The exact run's conv output extent: floor((e + 2p - k) / s) + 1, at
    least 1."""
    return torch.div((ext + 2 * padding - kernel).clamp_min(0), stride,
                     rounding_mode="floor") + 1


def stride4_extent(hw, conv_stem: bool, patch_size: int = 4):
    """The stride-4 extent (the stem's output, the head's logits) of a true
    image size ``hw``, on the host: the stem convs' k/s/p arithmetic (the
    conv stem two k3 s2 p1 convs, the patch stem one k = s = patch_size
    conv). Takes ints or numpy arrays."""
    e = np.asarray(hw)
    if conv_stem:
        s = patch_size // 2
        e = (e + 2 - 3) // s + 1
        e = (e + 2 - 3) // s + 1
    else:
        e = (e - patch_size) // patch_size + 1
    return e


def mask_for(hw, ext: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, W, 1) {0, 1} mask of the valid region."""
    H, W = int(hw[0]), int(hw[1])
    rows = torch.arange(H, dtype=torch.int32, device=ext.device)[None, :] < ext[:, 0:1]
    cols = torch.arange(W, dtype=torch.int32, device=ext.device)[None, :] < ext[:, 1:2]
    return (rows[:, :, None] & cols[:, None, :])[..., None].to(dtype)


def repeat_groups(ext: torch.Tensor, b: int) -> torch.Tensor:
    """``ext`` (B, ...) for a grouped batch of ``b`` = B·g rows, sample-major
    (the attention's (B, H, W, g, Cg) -> (B·g, ...) fold), as the JAX
    package's ``jnp.repeat(ext, g, 0)``."""
    eb = ext.shape[0]
    if b == eb:
        return ext
    if b % eb:
        raise ValueError(f"a batch of {b} rows for {eb} extents")
    return ext.repeat_interleave(b // eb, dim=0)


def mask_tensor(x: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """x (NHWC) times the mask of its valid region: zeros beyond each
    sample's extent. A grouped x of B·g rows takes its sample's extent."""
    return x * mask_for(x.shape[1:3], repeat_groups(ext, x.shape[0]), x.dtype)


# ---------------------------------------------------------------------------
# resizes and pooling at per-sample true sizes: the JAX package's weight
# matrices, applied with einsum on the device
# ---------------------------------------------------------------------------


def _axis_resize_matrix(pad_in: int, pad_out: int, in_ext: torch.Tensor,
                        out_ext: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """(B, pad_out, pad_in) bilinear weights of ``F.interpolate`` at the
    true sizes; rows at or beyond ``out_ext`` are zero, columns at or
    beyond ``in_ext`` are never referenced (so the pad region's values
    cannot leak in)."""
    dev = in_ext.device
    i = torch.arange(pad_out, dtype=torch.float32, device=dev)[None, :]
    s = in_ext.to(torch.float32)[:, None]
    d = out_ext.to(torch.float32)[:, None]
    if align_corners:
        src = i * (s - 1.0) / torch.clamp_min(d - 1.0, 1.0)
    else:
        src = torch.clamp_min((i + 0.5) * s / d - 0.5, 0.0)
    lo = torch.minimum(torch.floor(src), s - 1.0)
    hi = torch.minimum(lo + 1.0, s - 1.0)
    t = src - lo
    cols = torch.arange(pad_in, dtype=torch.float32, device=dev)[None, None, :]
    m = (torch.where(cols == lo[..., None], 1.0 - t[..., None], 0.0)
         + torch.where(cols == hi[..., None], t[..., None], 0.0))
    valid_row = torch.arange(pad_out, dtype=torch.int32, device=dev)[None, :] < out_ext[:, None]
    return m * valid_row[..., None].to(m.dtype)


def _apply(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """The separable (B, Ho, H) and (B, Wo, W) matrices applied to NHWC
    ``x``, in float32 (float64 for float64 x), the result in x's dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    y = torch.einsum("bhwc,boh->bowc", x.to(dt), mh.to(dt))
    y = torch.einsum("bhwc,bow->bhoc", y, mw.to(dt))
    return y.to(x.dtype)


def resize_bilinear_extent(x: torch.Tensor, out_hw, src_ext: torch.Tensor,
                           dst_ext: torch.Tensor, *, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to padded ``out_hw`` at each sample's
    true ratio (``src_ext`` -> ``dst_ext``, (B, 2)); zero beyond
    ``dst_ext``."""
    _, H, W, _ = x.shape
    Ho, Wo = int(out_hw[0]), int(out_hw[1])
    mh = _axis_resize_matrix(H, Ho, src_ext[:, 0], dst_ext[:, 0], align_corners)
    mw = _axis_resize_matrix(W, Wo, src_ext[:, 1], dst_ext[:, 1], align_corners)
    return _apply(x, mh, mw)


def _axis_nearest_matrix(pad_in: int, pad_out: int, in_ext: torch.Tensor,
                         out_ext: torch.Tensor) -> torch.Tensor:
    """One-hot (B, pad_out, pad_in) of torch's nearest rule (src =
    floor(dst · in / out)) at the true sizes."""
    dev = in_ext.device
    i = torch.arange(pad_out, dtype=torch.int32, device=dev)[None, :]
    src = torch.div(i * in_ext[:, None], out_ext[:, None].clamp_min(1), rounding_mode="floor")
    src = torch.minimum(src, (in_ext[:, None] - 1).clamp_min(0))
    cols = torch.arange(pad_in, dtype=torch.int32, device=dev)[None, None, :]
    m = (cols == src[..., None]).to(torch.float32)
    return m * (i < out_ext[:, None])[..., None].to(m.dtype)


def resize_nearest_extent(x: torch.Tensor, out_hw, src_ext: torch.Tensor,
                          dst_ext: torch.Tensor) -> torch.Tensor:
    """Nearest resize of NHWC ``x`` to padded ``out_hw`` at each sample's
    true sizes; zero beyond ``dst_ext``."""
    _, H, W, _ = x.shape
    Ho, Wo = int(out_hw[0]), int(out_hw[1])
    mh = _axis_nearest_matrix(H, Ho, src_ext[:, 0], dst_ext[:, 0])
    mw = _axis_nearest_matrix(W, Wo, src_ext[:, 1], dst_ext[:, 1])
    return _apply(x, mh, mw)


def _axis_adaptive_pool_matrix(pad_in: int, out_size: int, in_ext: torch.Tensor) -> torch.Tensor:
    """(B, out_size, pad_in) weights of ``nn.AdaptiveAvgPool2d`` over the
    true input size (bins floor(i·e/o) .. ceil((i+1)·e/o))."""
    dev = in_ext.device
    i = torch.arange(out_size, dtype=torch.int32, device=dev)[None, :]
    e = in_ext[:, None]
    lo = torch.div(i * e, out_size, rounding_mode="floor")
    hi = -torch.div(-(i + 1) * e, out_size, rounding_mode="floor")  # ceil
    r = torch.arange(pad_in, dtype=torch.int32, device=dev)[None, None, :]
    inside = (r >= lo[..., None]) & (r < hi[..., None])
    return inside.to(torch.float32) / (hi - lo)[..., None].clamp_min(1).to(torch.float32)


def adaptive_avg_pool_extent(x: torch.Tensor, out_hw, src_ext: torch.Tensor) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d(out_hw)`` of NHWC ``x`` over each sample's
    true extent. The output is wholly valid: no bin reaches past the
    extent, so the pad region never enters one."""
    _, H, W, _ = x.shape
    mh = _axis_adaptive_pool_matrix(H, int(out_hw[0]), src_ext[:, 0])
    mw = _axis_adaptive_pool_matrix(W, int(out_hw[1]), src_ext[:, 1])
    return _apply(x, mh, mw)
