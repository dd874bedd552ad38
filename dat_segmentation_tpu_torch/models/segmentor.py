"""EncoderDecoder segmentor and DatClassifier (NHWC), in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/segmentor.py:EncoderDecoder``:
backbone -> neck (SemanticFPN only) -> decode head, then the bilinear
upsample of the stride-4 logits to the input size unless
``upsample=False``. In training (``model.train()``) a segmentor with an
auxiliary head also runs it on ``feats[aux_in_index]`` and returns
``(logits, aux)``, both upsampled to the input size, as the JAX package
does with ``train=True``. ``DatClassifier`` is the backbone and a
``ClsHead`` (``segmentor.py:102`` there): image -> (B, num_classes) logits.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from ..ops.interpolate import resize_bilinear


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
        self, x: torch.Tensor, *, upsample: bool = True
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x (B, H, W, 3) -> logits (B, H, W, classes), or the head's
        stride-4 logits with ``upsample=False``; in training with an
        auxiliary head, ``(logits, aux)``."""
        feats = self.backbone(x)
        head_feats = self.neck(feats) if self.neck is not None else feats
        logits = self.decode_head(head_feats)
        if upsample:
            logits = resize_bilinear(logits, x.shape[1:3], align_corners=self.align_corners)
        if self.training and self.auxiliary_head is not None:
            aux = self.auxiliary_head(feats[self.aux_in_index])
            aux = resize_bilinear(aux, x.shape[1:3], align_corners=self.align_corners)
            return logits, aux
        return logits


class DatClassifier(nn.Module):
    """DAT backbone + ClsHead (reference models/dat_classifier.py)."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> logits (B, num_classes)."""
        return self.head(self.backbone(x))
