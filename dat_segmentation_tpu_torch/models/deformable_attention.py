"""Deformable multi-head attention (DAT++), in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/deformable_attention.py``,
on the path the DAT++ presets take:

* offsets come from a small net on the grouped queries (depthwise conv
  k/s, LayerNorm, GELU, 1x1 to 2 channels);
* ``offset_range_factor >= 0`` scales tanh(offsets) by that many grid
  steps; below 0 (the DAT++ presets) the raw offsets are added and the
  positions clipped to [-1, 1];
* keys and values are projected from the features bilinearly sampled at
  the deformed positions (``F.grid_sample``), groups folded back into
  channels as in the reference;
* attention with the continuous relative-position bias runs in the fused
  kernels (``ops/deform_attn.py``): on the card K1 forward and, in
  training, K2 for its gradient (q, k, v, the sample positions through
  the offset net and the clamp, and the float32 ``rpe_table``); on the
  CPU their plain versions under autograd. The kernels take any H and W,
  so the queries are not padded to 8-multiples as on the TPU. As the JAX
  package gates its kernel (``deformable_attention.py:243-252`` there):
  continuous RPE only, no ``no_off``, attention dropout 0.

The other position-bias modes (``dwc_pe``, ``fixed_pe``, ``log_cpb``),
``no_off``, a model without position bias and exact padded inference
(``ops/valid_extent.py``) are a later slice (ROADMAP.md, Queue 1) and
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..ops.deform_attn import deform_attn
from ..ops.grid_sample import grid_sample
from .layers import Conv2d, Dropout, LayerNorm2d, gelu

LATER_PE_SLICE = "the position-bias modes slice (ROADMAP.md, Queue 1)"


def reference_points(Hk: int, Wk: int, device=None) -> torch.Tensor:
    """Normalised (y, x) centres of the Hk x Wk sampling grid, (Hk, Wk, 2).

    Pixel centres divided by (size - 1), as the reference's
    ``_get_ref_points``: slightly inset from the border.
    """
    ys = (torch.arange(Hk, dtype=torch.float32, device=device) + 0.5) / max(Hk - 1.0, 1.0) * 2.0 - 1.0
    xs = (torch.arange(Wk, dtype=torch.float32, device=device) + 0.5) / max(Wk - 1.0, 1.0) * 2.0 - 1.0
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)


class DeformableAttention(nn.Module):
    """One deformable attention op (the 'D' block's core), NHWC in and out.

    ``q_size`` is the config-time feature size; it only shapes the
    (heads, 2*q_h-1, 2*q_w-1) relative-position table.
    """

    def __init__(
        self,
        dim: int,
        n_heads: int,
        n_groups: int,
        stride: int,
        ksize: int,
        q_size: Tuple[int, int],
        offset_range_factor: float = -1.0,
        use_pe: bool = True,
        dwc_pe: bool = False,
        fixed_pe: bool = False,
        log_cpb: bool = False,
        no_off: bool = False,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
    ):
        super().__init__()
        if dwc_pe or fixed_pe or log_cpb or no_off or not use_pe:
            raise NotImplementedError(
                "DeformableAttention ports the continuous position bias "
                "(use_pe without dwc_pe/fixed_pe/log_cpb/no_off) first; the "
                f"other modes are {LATER_PE_SLICE}"
            )
        self.dim, self.n_heads, self.n_groups = dim, n_heads, n_groups
        self.stride, self.ksize = stride, ksize
        self.offset_range_factor = offset_range_factor
        self.attn_drop = attn_drop
        cg = dim // n_groups
        pad = ksize // 2 if ksize != stride else 0
        self.proj_q = nn.Linear(dim, dim)
        self.offset_dwc = Conv2d(cg, cg, ksize, stride=stride, padding=pad, groups=cg)
        self.offset_ln = LayerNorm2d(cg)
        self.offset_proj = nn.Linear(cg, 2, bias=False)
        self.proj_k = nn.Linear(dim, dim)
        self.proj_v = nn.Linear(dim, dim)
        self.proj_out = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)
        th, tw = 2 * q_size[0] - 1, 2 * q_size[1] - 1
        self.rpe_table = nn.Parameter(torch.empty(n_heads, th, tw))
        nn.init.trunc_normal_(self.rpe_table, std=0.01, a=-0.02, b=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        g, heads = self.n_groups, self.n_heads
        cg, h_g = C // g, heads // g
        if self.training and self.attn_drop > 0.0:
            raise NotImplementedError(
                "attention dropout is not ported: the kernels compute none, "
                "and every DAT++ preset has attn_drop_rate 0"
            )

        def grouped(t):  # (B, H, W, C) -> (B*g, H, W, Cg)
            return t.reshape(B, H, W, g, cg).permute(0, 3, 1, 2, 4).reshape(B * g, H, W, cg)

        q = self.proj_q(x)
        q_g = grouped(q)
        offset = self.offset_proj(gelu(self.offset_ln(self.offset_dwc(q_g)))).float()
        Hk, Wk = offset.shape[1:3]
        Ns = Hk * Wk
        if self.offset_range_factor >= 0:
            rng = offset.new_tensor([1.0 / (Hk - 1.0), 1.0 / (Wk - 1.0)])
            offset = torch.tanh(offset) * rng * self.offset_range_factor
        pos = offset + reference_points(Hk, Wk, x.device)  # (B*g, Hk, Wk, 2), (y, x)
        if self.offset_range_factor < 0:
            pos = pos.clamp(-1.0, 1.0)

        samp = grid_sample(grouped(x), pos.flip(-1))  # grid in (x, y) order
        # contiguous: for a strided 3-d input, nn.Linear's matmul takes one
        # path or another by the weight's requires_grad, which rounds
        # differently on the card (a frozen, exported copy against the server)
        sampled = samp.reshape(B, g, Ns, cg).permute(0, 2, 1, 3).reshape(B, Ns, C).contiguous()
        k = self.proj_k(sampled)
        v = self.proj_v(sampled)

        def by_group(t):  # (B, Ns, C) -> (B*g, Ns, Cg)
            return t.reshape(B, Ns, g, cg).permute(0, 2, 1, 3).reshape(B * g, Ns, cg)

        th, tw = self.rpe_table.shape[1:]
        out = deform_attn(
            q_g.contiguous(),
            by_group(k).contiguous(),
            by_group(v).contiguous(),
            pos.reshape(B * g, Ns, 2).contiguous(),
            self.rpe_table.reshape(g, h_g, th, tw),
            n_groups=g,
            scale=(C // heads) ** -0.5,
        )
        out = out.reshape(B, g, H, W, cg).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj_drop(self.proj_out(out))
