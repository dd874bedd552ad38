"""EncoderDecoder segmentor and DatClassifier (NHWC), in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/segmentor.py:EncoderDecoder``:
backbone -> neck (SemanticFPN only) -> decode head, then the bilinear
upsample of the stride-4 logits to the input size unless
``upsample=False``. In training (``model.train()``) a segmentor with an
auxiliary head also runs it on ``feats[aux_in_index]`` and returns
``(logits, aux)``, both upsampled to the input size, as the JAX package
does with ``train=True``. ``DatClassifier`` is the backbone and a
``ClsHead`` (``segmentor.py:102`` there): image -> (B, num_classes) logits.

Over the mesh's spatial axis both take a row shard of the image and its
layout (``rows``, ``parallel/spatial.py``): a segmentor returns the row
shards of its logits at the image's layout, a classifier its logits
replicated on every spatial peer.

``valid_hw`` ((B, 2) per-sample true image sizes) runs the segmentor's
exact padded inference (``ops/valid_extent.py``, the JAX package's
``segmentor.py:42-70``): the forward of a zero-padded batch equals, on
each sample's valid region, the forward of that sample alone at its true
shape. It returns stride-4 logits (``upsample=False``), which the caller
slices to each sample's stride-4 extent before resizing. The JAX eval
runs it outside any mesh, so it is refused on a row shard (``rows``) and
on a model whose modules the mesh's model axis splits.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from ..ops import valid_extent
from ..ops.interpolate import resize_bilinear
from ..parallel.spatial import Rows
from ..utils import profiling


class EncoderDecoder(nn.Module):
    def __init__(
        self,
        backbone: nn.Module,
        decode_head: nn.Module,
        neck: Optional[nn.Module] = None,
        align_corners: bool = False,
        auxiliary_head: Optional[nn.Module] = None,
        aux_in_index: int = 2,
    ):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.decode_head = decode_head
        self.auxiliary_head = auxiliary_head
        self.align_corners = align_corners
        self.aux_in_index = aux_in_index

    def forward(
        self, x: torch.Tensor, *, upsample: bool = True, rows: Optional[Rows] = None,
        valid_hw: Optional[torch.Tensor] = None,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x (B, H, W, 3) -> logits (B, H, W, classes), or the head's
        stride-4 logits with ``upsample=False``; in training with an
        auxiliary head, ``(logits, aux)``. On a row shard of the image
        (``rows``) the logits' row shards. ``valid_hw`` (B, 2): exact
        padded inference of a zero-padded batch, stride-4 logits."""
        if valid_hw is None:
            return self._forward(x, upsample, rows)
        if upsample:
            raise ValueError("exact padded inference returns stride-4 logits; the caller "
                             "slices them to the true extent and resizes (upsample=False)")
        if rows is not None or any(getattr(m, "model_axis", None) is not None
                                   for m in self.modules()):
            raise ValueError("exact padded inference (valid_hw) runs outside the mesh: not "
                             "on a row shard (rows) nor on a model split over the model axis")
        valid_hw = torch.as_tensor(valid_hw, dtype=torch.int32, device=x.device)
        with valid_extent.exact_extent(x.shape[1:3], valid_hw):
            return self._forward(x, upsample, rows)

    def _forward(self, x, upsample, rows):
        with profiling.span("dat.backbone"):
            if rows is None:  # a registered head may take the features alone
                feats = self.backbone(x)
                fr, kw, aux_kw = [None] * len(feats), {}, {}
            else:
                feats, fr = self.backbone(x, rows)
                kw, aux_kw = {"rows": fr}, {"rows": fr[self.aux_in_index]}
        hw = (x.shape[1] if rows is None else rows.H, x.shape[2])
        with profiling.span("dat.heads"):
            head_feats = self.neck(feats, **kw) if self.neck is not None else feats
            logits = self.decode_head(head_feats, **kw)
            if upsample:
                logits = resize_bilinear(logits, hw, align_corners=self.align_corners, rows=fr[0])
            if self.training and self.auxiliary_head is not None:
                i = self.aux_in_index
                aux = self.auxiliary_head(feats[i], **aux_kw)
                aux = resize_bilinear(aux, hw, align_corners=self.align_corners, rows=fr[i])
                return logits, aux
            return logits


class DatClassifier(nn.Module):
    """DAT backbone + ClsHead (reference models/dat_classifier.py)."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        """x (B, H, W, 3) -> logits (B, num_classes); of a row shard of the
        image (``rows``) too, replicated on the spatial peers."""
        if rows is None:
            return self.head(self.backbone(x))
        return self.head(*self.backbone(x, rows))
