"""Deformable multi-head attention (DAT / DAT++), in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/deformable_attention.py``:

* offsets come from a small net on the grouped queries (depthwise conv
  k/s, LayerNorm, GELU, 1x1 to 2 channels);
* ``offset_range_factor >= 0`` scales tanh(offsets) by that many grid
  steps; below 0 (the DAT++ presets) the raw offsets are added and the
  positions clipped to [-1, 1];
* keys and values are projected from the features bilinearly sampled at
  the deformed positions (``F.grid_sample``), groups folded back into
  channels as in the reference; with ``no_off`` the net still runs, its
  output is dropped and the keys and values come from a stride x stride
  average pool of the features (H and W must be multiples of the stride);
* the attention takes one of the position-bias modes: the continuous
  relative-position bias (a (heads, 2*q_h-1, 2*q_w-1) table sampled at
  half the query-to-sample displacement), ``dwc_pe`` (a 3x3 depthwise conv
  of the queries added to the output, no bias), ``fixed_pe`` (a (heads,
  q_h*q_w, kv_h*kv_w) table resized to the runtime (H*W, Ns)),
  ``log_cpb`` (a 2-32-h_g MLP of log-spaced displacements), or none
  (``use_pe=False``, or ``no_off``). The PE tables take their shapes from
  the config-time ``q_size``, not the runtime H, W.

The JAX package gates its fused kernel (``deformable_attention.py:243-252``
there) to the continuous bias, without ``no_off``, with attention dropout
0 or in eval; every other block runs its XLA composite. The port gates its
kernels the same way (``runs_kernel``): there K1 runs on the card and, in
training, K2 for its gradient (q, k, v, the sample positions through the
offset net and the clamp, and the float32 ``rpe_table``), through
``ops/deform_attn.py``; on the CPU their plain versions under autograd.
The kernels take any H and W, so the queries are not padded to
8-multiples as on the TPU. Every other block runs the JAX composite in
plain PyTorch (``_composite``): q·kᵀ·scale in float32, the mode's bias,
the softmax in float32, attention dropout on the caller's generator, ·v,
then ``dwc_pe``'s term. That split is the JAX design: a failing K1 build
or launch raises, and never drops to the composite.

Over the mesh's model axis (``parallel/model_axis.py``) a block that runs
K1 splits by offset group: this rank's groups' queries, offsets, samples
and K1 launch (on B·g/Y groups), the sampled features of every group
gathered for ``proj_k``/``proj_v`` (this rank's heads), ``proj_out``'s
partial sums all-reduced; the composite's blocks stay whole.

Over the mesh's spatial axis the stage runs this module on whole maps of
part of the data coordinate's batch (``models/dat.py:TransformerStage.
_attend``); ``batch`` then places its dropout masks in the data
coordinate's, under a model axis too (the model peers of a spatial
coordinate take the same batch rows, and a split block's masks cover
whole channels).

Exact padded inference (``ops/valid_extent.py``: per-sample true extents
inside a padded batch) is not ported; the port runs every input at its
true shape.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_attn import deform_attn, query_coords, rpe_bias
from ..ops.grid_sample import grid_sample
from ..ops.interpolate import avg_pool, resize_bilinear
from ..parallel import mesh
from .layers import Conv2d, Dropout, LayerNorm2d, entering, gelu, row_parallel


def reference_points(Hk: int, Wk: int, device=None) -> torch.Tensor:
    """Normalised (y, x) centres of the Hk x Wk sampling grid, (Hk, Wk, 2).

    Pixel centres divided by (size - 1), as the reference's
    ``_get_ref_points``: slightly inset from the border.
    """
    ys = (torch.arange(Hk, dtype=torch.float32, device=device) + 0.5) / max(Hk - 1.0, 1.0) * 2.0 - 1.0
    xs = (torch.arange(Wk, dtype=torch.float32, device=device) + 0.5) / max(Wk - 1.0, 1.0) * 2.0 - 1.0
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)


def query_grid(H: int, W: int, device=None) -> torch.Tensor:
    """Normalised (y, x) query coordinates, corners at exactly -1 and +1,
    (H, W, 2): the reference's ``_get_q_grid`` (not the pixel centres of
    ``reference_points``), divided by a tensor as ``query_coords`` says."""
    ys, xs = query_coords(H, H, device), query_coords(W, W, device)
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)


class DeformableAttention(nn.Module):
    """One deformable attention op (the 'D' block's core), NHWC in and out.

    ``q_size`` is the config-time feature size; it only shapes the
    position-bias tables (``rpe_table``, continuous or ``fixed_pe``).
    """

    model_axis: Optional[mesh.ModelAxis] = None  # set where the model axis splits it

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
        self.dim, self.n_heads, self.n_groups = dim, n_heads, n_groups
        self.stride, self.ksize = stride, ksize
        self.offset_range_factor = offset_range_factor
        self.use_pe, self.dwc_pe, self.fixed_pe = use_pe, dwc_pe, fixed_pe
        self.log_cpb, self.no_off = log_cpb, no_off
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
        self.attn_dropout = Dropout(attn_drop)
        # the reference's precedence: dwc_pe, fixed_pe, log_cpb, continuous
        if use_pe and not no_off:
            if dwc_pe:
                self.rpe_dwc = Conv2d(dim, dim, 3, padding=1, groups=dim)
            elif fixed_pe:
                kv = (q_size[0] // stride) * (q_size[1] // stride)
                self.rpe_table = nn.Parameter(torch.empty(n_heads, q_size[0] * q_size[1], kv))
            elif log_cpb:
                self.cpb_fc1 = nn.Linear(2, 32)
                self.cpb_fc2 = nn.Linear(32, n_heads // n_groups, bias=False)
            else:
                th, tw = 2 * q_size[0] - 1, 2 * q_size[1] - 1
                self.rpe_table = nn.Parameter(torch.empty(n_heads, th, tw))
            if hasattr(self, "rpe_table"):
                nn.init.trunc_normal_(self.rpe_table, std=0.01, a=-0.02, b=0.02)

    def splits_by_group(self) -> bool:
        """The kernel's modes in training (``runs_kernel`` with the module in
        training): the blocks the model axis splits by offset group."""
        return (self.use_pe and not (self.dwc_pe or self.fixed_pe or self.log_cpb)
                and not self.no_off and self.attn_drop == 0.0)

    def runs_kernel(self) -> bool:
        """The JAX package's gate (``deformable_attention.py:243-252`` there,
        less its exact-padding clause): the continuous bias, offsets on, and
        attention dropout 0 or eval. Then K1 (and K2 under grad) computes
        the attention; else the composite."""
        return (self.use_pe and not (self.dwc_pe or self.fixed_pe or self.log_cpb)
                and not self.no_off and (self.attn_drop == 0.0 or not self.training))

    def forward(self, x: torch.Tensor, batch: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H, W, C); ``batch`` (first row, data
        coordinate's batch size): x holds those batch rows of it."""
        B, H, W, C = x.shape
        ax = self.model_axis
        parts = 1 if ax is None else ax.size
        cg, h_g = C // self.n_groups, self.n_heads // self.n_groups
        g = self.n_groups // parts  # this rank's groups: all, or 1/Y of them
        cl = g * cg  # their channels
        if self.no_off and (H % self.stride or W % self.stride):
            raise ValueError(f"no_off pools the features {self.stride}x{self.stride}: H and W "
                             f"must be multiples of {self.stride}, got {H}x{W}")

        def grouped(t):  # (B, H, W, cl) -> (B*g, H, W, Cg)
            return t.reshape(B, H, W, g, cg).permute(0, 3, 1, 2, 4).reshape(B * g, H, W, cg)

        x = entering(x, ax)
        q = self.proj_q(x)
        q_g = grouped(q)
        offset = self.offset_proj(gelu(self.offset_ln(self.offset_dwc(q_g)))).float()
        Hk, Wk = offset.shape[1:3]
        Ns = Hk * Wk
        if self.no_off:
            # the net runs and its output is dropped, as in the JAX package
            offset = torch.zeros_like(offset)
        elif self.offset_range_factor >= 0:
            rng = offset.new_tensor([1.0 / (Hk - 1.0), 1.0 / (Wk - 1.0)])
            offset = torch.tanh(offset) * rng * self.offset_range_factor
        pos = offset + reference_points(Hk, Wk, x.device)  # (B*g, Hk, Wk, 2), (y, x)
        if self.offset_range_factor < 0:
            pos = pos.clamp(-1.0, 1.0)

        if self.no_off:
            sampled = avg_pool(x, self.stride, self.stride).reshape(B, Ns, C)
        else:
            xl = x if ax is None else mesh.slice_of(x, 3, ax)
            samp = grid_sample(grouped(xl), pos.flip(-1))  # grid in (x, y) order
            sampled = samp.reshape(B, g, Ns, cg).permute(0, 2, 1, 3).reshape(B, Ns, cl)
            if ax is not None:  # every group's samples, for this rank's heads
                sampled = mesh.gather_model(sampled.contiguous(), ax, -1, split_consumer=True)
        # contiguous: for a strided 3-d input, nn.Linear's matmul takes one
        # path or another by the weight's requires_grad, which rounds
        # differently on the card (a frozen, exported copy against the server)
        sampled = sampled.contiguous()
        k = self.proj_k(sampled)
        v = self.proj_v(sampled)
        pos = pos.reshape(B * g, Ns, 2)

        if not self.runs_kernel():
            return self.proj_drop(self.proj_out(self._composite(q, k, v, pos, H, W, batch)),
                                  batch=batch)

        def by_group(t):  # (B, Ns, cl) -> (B*g, Ns, Cg)
            return t.reshape(B, Ns, g, cg).permute(0, 2, 1, 3).reshape(B * g, Ns, cg)

        th, tw = self.rpe_table.shape[1:]
        out = deform_attn(
            q_g.contiguous(),
            by_group(k).contiguous(),
            by_group(v).contiguous(),
            pos.contiguous(),
            self.rpe_table.reshape(g, h_g, th, tw),
            n_groups=g,
            scale=(C // self.n_heads) ** -0.5,
        )
        out = out.reshape(B, g, H, W, cg).permute(0, 2, 3, 1, 4).reshape(B, H, W, cl)
        return self.proj_drop(row_parallel(self.proj_out, out, ax), batch=batch)

    def _composite(self, q, k, v, pos, H: int, W: int, batch=None) -> torch.Tensor:
        """The JAX package's composite (``deformable_attention.py:299-524``
        there) on q (B, H, W, C), k, v (B, Ns, C) and pos (B*g, Ns, 2): the
        products and the softmax in float32, P rounded to q's dtype for the
        dropout and P·V, the output in q's dtype, (B, H, W, C)."""
        B, _, _, C = q.shape
        heads, Ns = self.n_heads, k.shape[1]
        hc = C // heads
        qh = q.reshape(B, H * W, heads, hc).float()
        kh = k.reshape(B, Ns, heads, hc).float()
        attn = torch.einsum("bmhc,bnhc->bhmn", qh, kh) * hc ** -0.5
        bias = self._bias(pos, B, H, W)
        if bias is not None:
            attn = attn + bias
        p = self.attn_dropout(torch.softmax(attn, dim=-1).to(q.dtype), batch=batch)
        out = torch.einsum("bhmn,bnhc->bmhc", p.float(), v.reshape(B, Ns, heads, hc).float())
        out = out.reshape(B, H, W, C).to(q.dtype)
        if hasattr(self, "rpe_dwc"):
            out = out + self.rpe_dwc(q)
        return out

    def _bias(self, pos: torch.Tensor, B: int, H: int, W: int) -> Optional[torch.Tensor]:
        """The mode's position bias, float32, broadcastable to (B, heads,
        H*W, Ns); None for ``dwc_pe``, ``no_off`` and ``use_pe=False``."""
        g, heads = self.n_groups, self.n_heads
        h_g, Ns = heads // g, pos.shape[1]
        if hasattr(self, "cpb_fc1"):  # log_cpb
            qg = query_grid(H, W, pos.device).reshape(1, H * W, 1, 2)
            disp = (qg - pos[:, None]) * 4.0  # (B*g, H*W, Ns, 2)
            disp = torch.sign(disp) * torch.log2(disp.abs() + 1.0) / disp.new_tensor(math.log2(8.0))
            # float32, as flax's Dense promotes its bf16 weights to the
            # float32 displacements
            hb = F.relu(F.linear(disp, self.cpb_fc1.weight.float(), self.cpb_fc1.bias.float()))
            bias = F.linear(hb, self.cpb_fc2.weight.float())  # (B*g, H*W, Ns, h_g)
            return bias.reshape(B, g, H * W, Ns, h_g).permute(0, 1, 4, 2, 3).reshape(
                B, heads, H * W, Ns)
        if not hasattr(self, "rpe_table"):
            return None
        table = self.rpe_table
        if self.fixed_pe:
            # the reference's 2-d align-corners resize over the table's two
            # flat axes, in float32, the result in the table's dtype
            bias = resize_bilinear(table.float()[None].permute(0, 2, 3, 1), (H * W, Ns),
                                   align_corners=True)
            return bias.permute(0, 3, 1, 2).to(table.dtype).float()  # (1, heads, H*W, Ns)
        th, tw = table.shape[1:]
        return rpe_bias(pos, table.reshape(g, h_g, th, tw), H, W).reshape(B, heads, H * W, Ns)
