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
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from ..ops.interpolate import resize_bilinear
from ..parallel.spatial import Rows


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
        self, x: torch.Tensor, *, upsample: bool = True, rows: Optional[Rows] = None
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x (B, H, W, 3) -> logits (B, H, W, classes), or the head's
        stride-4 logits with ``upsample=False``; in training with an
        auxiliary head, ``(logits, aux)``. On a row shard of the image
        (``rows``) the logits' row shards."""
        if rows is None:  # a registered head may take the features alone
            feats = self.backbone(x)
            fr, kw, aux_kw = [None] * len(feats), {}, {}
        else:
            feats, fr = self.backbone(x, rows)
            kw, aux_kw = {"rows": fr}, {"rows": fr[self.aux_in_index]}
        hw = (x.shape[1] if rows is None else rows.H, x.shape[2])
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
