"""Decode heads (NHWC), in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/heads.py`` for the
heads: ``ConvBNReLU``, ``UPerHead`` (with its PPM) and the auxiliary
``FCNHead`` of the UperNet presets, ``FPNNeck`` and ``FPNHead`` of the
SemanticFPN ones, and the classifier's ``ClsHead``. Dropout is
elementwise and draws from the generator that ``layers.use_generator``
hands it.

Under exact padded inference (``ops/valid_extent.py``) the heads take the
JAX package's extent forms (``heads.py:26-35, 83-121, 186-210, 240-290``
there): the bilinear resizes run at the levels' true ratios whenever their
extents are known; ``UPerHead``'s PPM pools over the true extent, its 1x1
convs on the wholly valid pooled maps with masking suspended; ``FPNNeck``'s
nearest top-down adds take the extent form; ``FPNHead`` tracks extents
itself with the shared map suspended (an upsampled stride-32 map has true
extent 2·e32, not the stride-16 map's e16, though their padded shapes
agree), masking each level's input.

Over the mesh's model axis (``parallel/model_axis.py``) each
``ConvBNReLU``, ``FPNNeck``'s laterals and output convs and ``ClsHead.fc``
hold this rank's output channels (a BatchNorm its channels' statistics
over the data group, over data × spatial on a row shard) and gather the
peers' outputs (``column``): no conv of a head stays whole, and what
follows each runs whole on every peer. Beside a spatial axis the convs run
on row shards, fetching their halos on this rank's channels.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import valid_extent
from ..ops.interpolate import adaptive_avg_pool, resize_bilinear, resize_nearest
from ..parallel import mesh, spatial
from ..parallel.spatial import Rows
from .layers import BatchNorm2d, Conv2d, Dropout, LayerNorm2d, entering

RowsList = Optional[Sequence[Optional[Rows]]]


def _rows_of(rows: RowsList, n: int) -> List[Optional[Rows]]:
    return list(rows) if rows is not None else [None] * n


def _height(x: torch.Tensor, rows: Optional[Rows]) -> int:
    return x.shape[1] if rows is None else rows.H


def _extents(feats: Sequence[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """Each level's per-sample extents under exact padded inference (None
    for a level without, and outside it)."""
    return [valid_extent.lookup(f.shape[1:3]) for f in feats]


def _resize(x: torch.Tensor, out_hw, src_ext, dst_ext, align_corners: bool = False,
            rows: Optional[Rows] = None) -> torch.Tensor:
    """The bilinear resize, or its form at the true extents when both are
    known (exact padded inference)."""
    if src_ext is not None and dst_ext is not None:
        return valid_extent.resize_bilinear_extent(x, out_hw, src_ext, dst_ext,
                                                   align_corners=align_corners)
    return resize_bilinear(x, out_hw, align_corners=align_corners, rows=rows)


def column(fn, x: torch.Tensor, axis) -> torch.Tensor:
    """``fn(x)`` for ``fn`` holding this rank's output channels of a layer
    split over ``axis``: ``x`` (whole) entering split compute, the peers'
    outputs gathered for the replicated compute after it. ``fn(x)`` alone
    without an axis."""
    if axis is None:
        return fn(x)
    return mesh.gather_model(fn(entering(x, axis)), axis, -1)


class ConvBNReLU(nn.Module):
    """conv (no bias) + BN + ReLU, the mmseg ConvModule default."""

    model_axis: Optional[mesh.ModelAxis] = None

    def __init__(self, in_ch: int, features: int, kernel: int = 3):
        super().__init__()
        self.conv = Conv2d(in_ch, features, kernel, padding=kernel // 2, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        return column(lambda t: F.relu(self.bn(self.conv(t, rows), rows)), x, self.model_axis)


class UPerHead(nn.Module):
    """UperNet decode head: PPM on the deepest feature, 1x1 laterals, the
    top-down path, the fuse bottleneck, dropout and ``cls_seg``.

    ``topdown`` selects the JAX package's two orders, which share their
    parameters: ``'mmseg'`` adds every top-down contribution to the raw
    laterals and then refines each level; ``'standalone'`` refines each
    level inside the top-down loop (heads.py:139-149 there).
    """

    def __init__(
        self,
        in_channels: Sequence[int],
        num_classes: int,
        channels: int = 512,
        pool_scales: Sequence[int] = (1, 2, 3, 6),
        dropout_ratio: float = 0.1,
        topdown: str = "mmseg",
    ):
        super().__init__()
        if topdown not in ("mmseg", "standalone"):
            raise ValueError(f"topdown {topdown!r}: 'mmseg' or 'standalone'")
        self.n = len(in_channels)
        self.pool_scales = tuple(pool_scales)
        self.topdown = topdown
        ppm_c = channels // len(self.pool_scales)
        for j in range(len(self.pool_scales)):
            self.add_module(f"ppm_{j}", ConvBNReLU(in_channels[-1], ppm_c, 1))
        self.ppm_bottleneck = ConvBNReLU(
            in_channels[-1] + len(self.pool_scales) * ppm_c, channels, 3
        )
        for i in range(self.n - 1):
            self.add_module(f"lateral_{i}", ConvBNReLU(in_channels[i], channels, 1))
            self.add_module(f"fpn_{i}", ConvBNReLU(channels, channels, 3))
        self.fuse_bottleneck = ConvBNReLU(self.n * channels, channels, 3)
        self.dropout = Dropout(dropout_ratio)
        self.cls_seg = nn.Linear(channels, num_classes)

    def forward(self, feats: Sequence[torch.Tensor], rows: RowsList = None) -> torch.Tensor:
        n = self.n
        rows = _rows_of(rows, n)
        exts = _extents(feats)
        deep, r = feats[-1], rows[-1]
        whole = deep if r is None else spatial.gather_rows(deep, r)
        ppm = [deep]
        for j, scale in enumerate(self.pool_scales):
            ppm_j = getattr(self, f"ppm_{j}")
            if exts[-1] is not None:
                # bins over the true extent; the (scale, scale) map is wholly
                # valid, so only the resize back up needs the true ratios
                p = valid_extent.adaptive_avg_pool_extent(deep, (scale, scale), exts[-1])
                full = torch.full_like(exts[-1], scale)
                with valid_extent.suspend():
                    p = ppm_j(p)
            else:
                p, full = ppm_j(adaptive_avg_pool(whole, (scale, scale))), None
            up = _resize(p, whole.shape[1:3], full, exts[-1])
            ppm.append(up if r is None else spatial.keep_rows(up, r))
        laterals = [getattr(self, f"lateral_{i}")(feats[i], rows[i]) for i in range(n - 1)]
        laterals.append(self.ppm_bottleneck(torch.cat(ppm, dim=-1), r))

        def size(i):  # level i's global (H, W)
            return _height(laterals[i], rows[i]), laterals[i].shape[2]

        def up(i, j):  # level i resized to level j
            return _resize(laterals[i], size(j), exts[i], exts[j], rows=rows[i])

        fpn = [getattr(self, f"fpn_{i}") for i in range(n - 1)]
        if self.topdown == "mmseg":
            for i in range(n - 1, 0, -1):
                laterals[i - 1] = laterals[i - 1] + up(i, i - 1)
            outs = [fpn[i](laterals[i], rows[i]) for i in range(n - 1)] + [laterals[-1]]
        else:
            for i in range(n - 1, 0, -1):
                laterals[i - 1] = fpn[i - 1](laterals[i - 1] + up(i, i - 1), rows[i - 1])
            outs = laterals

        target = size(0)
        outs = [outs[0]] + [_resize(o, target, exts[i + 1], exts[0], rows=rows[i + 1])
                            for i, o in enumerate(outs[1:])]
        x = self.fuse_bottleneck(torch.cat(outs, dim=-1), rows[0])
        return self.cls_seg(self.dropout(x, rows=rows[0]))


class FCNHead(nn.Module):
    """Auxiliary FCN head: ``num_convs`` 3x3 ConvBNReLU, dropout,
    ``cls_seg``."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int,
        channels: int = 256,
        num_convs: int = 1,
        dropout_ratio: float = 0.1,
    ):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv_{i}", ConvBNReLU(in_channels if i == 0 else channels, channels, 3))
        self.dropout = Dropout(dropout_ratio)
        self.cls_seg = nn.Linear(channels, num_classes)

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"conv_{i}")(x, rows)
        return self.cls_seg(self.dropout(x, rows=rows))


class FPNNeck(nn.Module):
    """mmseg-style FPN neck: 1x1 laterals (bias, no norm), nearest top-down
    adds, 3x3 output convs."""

    model_axis: Optional[mesh.ModelAxis] = None

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", nn.Linear(c, out_channels))
            self.add_module(f"fpn_{i}", Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats: Sequence[torch.Tensor], rows: RowsList = None) -> List[torch.Tensor]:
        ax = self.model_axis
        rows = _rows_of(rows, self.n)
        exts = _extents(feats)
        laterals = [column(getattr(self, f"lateral_{i}"), f, ax) for i, f in enumerate(feats)]
        for i in range(self.n - 1, 0, -1):
            hw = (_height(laterals[i - 1], rows[i - 1]), laterals[i - 1].shape[2])
            if exts[i] is not None:
                up = valid_extent.resize_nearest_extent(laterals[i], hw, exts[i], exts[i - 1])
            else:
                up = resize_nearest(laterals[i], hw, rows[i])
            laterals[i - 1] = laterals[i - 1] + up
        return [column(lambda t, i=i: getattr(self, f"fpn_{i}")(t, rows[i]), lat, ax)
                for i, lat in enumerate(laterals)]


class FPNHead(nn.Module):
    """Semantic-FPN decode head: per level, a chain of [3x3 ConvBNReLU +
    2x bilinear upsample] down to stride 4, summed, then classified."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int,
        feature_strides: Sequence[int] = (4, 8, 16, 32),
        channels: int = 128,
        dropout_ratio: float = 0.1,
        align_corners: bool = False,
    ):
        super().__init__()
        self.feature_strides = tuple(feature_strides)
        self.align_corners = align_corners
        fs = self.feature_strides
        self.head_lengths = [
            max(1, int(math.log2(fs[i]) - math.log2(fs[0]))) for i in range(len(fs))
        ]
        for i, length in enumerate(self.head_lengths):
            for k in range(length):
                self.add_module(
                    f"scale_{i}_{k}",
                    ConvBNReLU(in_channels if k == 0 else channels, channels, 3),
                )
        self.dropout = Dropout(dropout_ratio)
        self.cls_seg = nn.Linear(channels, num_classes)

    def forward(self, feats: Sequence[torch.Tensor], rows: RowsList = None) -> torch.Tensor:
        fs, ac = self.feature_strides, self.align_corners
        rows = _rows_of(rows, len(feats))
        exts = _extents(feats)
        # exact padded inference tracks the extents here, the shared map
        # suspended: an upsampled map lands on a padded shape registered
        # at another true extent
        exact = valid_extent.current() is not None and all(e is not None for e in exts)
        out = out_ext = None
        with valid_extent.suspend() if exact else contextlib.nullcontext():
            for i, length in enumerate(self.head_lengths):
                x, r, e = feats[i], rows[i], exts[i]
                if exact:
                    x = valid_extent.mask_tensor(x, e)
                for k in range(length):
                    x = getattr(self, f"scale_{i}_{k}")(x, r)
                    if fs[i] != fs[0]:
                        h = _height(x, r) * 2
                        if exact:  # a 2x upsample: the true size doubles too
                            x = valid_extent.resize_bilinear_extent(
                                x, (h, x.shape[2] * 2), e, 2 * e, align_corners=ac)
                            e = 2 * e
                        else:
                            x = resize_bilinear(x, (h, x.shape[2] * 2), align_corners=ac, rows=r)
                        r = None if r is None else r.at(h)
                if out is None:
                    out, out_ext = x, e
                elif exact:  # to level 0's true shape (the padded shapes agree)
                    out = out + valid_extent.resize_bilinear_extent(
                        x, out.shape[1:3], e, out_ext, align_corners=ac)
                else:
                    hw = (_height(out, rows[0]), out.shape[2])
                    out = out + resize_bilinear(x, hw, align_corners=ac, rows=r)
        return self.cls_seg(self.dropout(out, rows=rows[0]))


class ClsHead(nn.Module):
    """Classification head (reference models/heads/cls_head.py:10-38): LN on
    the last feature, the mean over H and W, dropout, ``fc``."""

    model_axis: Optional[mesh.ModelAxis] = None

    def __init__(self, in_channels: int, num_classes: int, dropout_ratio: float = 0.0):
        super().__init__()
        self.norm = LayerNorm2d(in_channels)
        self.drop = Dropout(dropout_ratio)
        self.fc = nn.Linear(in_channels, num_classes)

    def forward(self, feats: Sequence[torch.Tensor], rows: RowsList = None) -> torch.Tensor:
        r = _rows_of(rows, len(feats))[-1]
        x = self.norm(feats[-1])
        if r is None:
            x = x.mean(dim=(1, 2))
        else:  # each peer's rows' sum, summed over the peers
            x = spatial.sum_over_peers(x.sum(dim=(1, 2)), r.axis) / (r.H * x.shape[2])
        return column(self.fc, self.drop(x), self.model_axis)
