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

Over the mesh's model axis (``parallel/model_axis.py``) a block whose
offset groups divide by Y splits by offset group, in every mode: this
rank's groups' queries, offsets and samples, the sampled features of every
group gathered for ``proj_k``/``proj_v`` (this rank's heads; ``no_off``'s
pooled features hold every channel already), then K1 (on B·g/Y groups) or
the composite on this rank's heads (``rpe_table`` split by head,
``rpe_dwc`` by channel, ``log_cpb``'s MLP whole and evaluated for this
rank's groups, attention dropout on this rank's heads of the whole mask),
``proj_out``'s partial sums all-reduced.

Over the mesh's spatial axis the stage runs this module on whole maps of
part of the data coordinate's batch (``models/dat.py:TransformerStage.
_attend``); ``batch`` then places its dropout masks in the data
coordinate's, under a model axis too (the model peers of a spatial
coordinate take the same batch rows, and a split block's masks cover
whole channels).

Under exact padded inference (``ops/valid_extent.py``: a zero-padded
batch whose samples have their own true extents, the JAX package's
``deformable_attention.py:103-110, 139-216, 299-527``) every size-dependent
quantity takes the sample's true extent: the kv extent is the offset
conv's own arithmetic (``ext_q // stride`` with ``no_off``), the tanh
range is over the true kv extent, the reference grid spans it, the
positions (normalised over the true extent) feed the bias while their
rescaling ``(pos + 1)·(ext_q - 1)/(H - 1) - 1`` feeds the sampler on the
features zeroed beyond ``ext_q``, the query grid of the continuous bias
and of ``log_cpb`` is per sample, ``fixed_pe`` resizes its table along
the flat axes of each sample's true sizes (per-sample tap-weight
products), and the kv points beyond the true grid leave the softmax. K1
takes no per-sample extents, so the JAX gate routes such a block to its
composite (``and not exact`` there, ``runs_kernel(exact=True)`` here): a
design of the reference, not a fallback; a K1 build or launch failure
raises as ever.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import valid_extent
from ..ops.deform_attn import deform_attn, query_coords, rpe_bias, rpe_bias_at
from ..ops.grid_sample import grid_sample, lerp_weight_matrix
from ..ops.interpolate import avg_pool, resize_bilinear
from ..parallel import mesh
from ..utils import profiling
from .layers import Conv2d, Dropout, LayerNorm2d, entering, gelu, row_parallel


def reference_points(Hk: int, Wk: int, device=None) -> torch.Tensor:
    """Normalised (y, x) centres of the Hk x Wk sampling grid, (Hk, Wk, 2).

    Pixel centres divided by (size - 1), as the reference's
    ``_get_ref_points``: slightly inset from the border.
    """
    ys = (torch.arange(Hk, dtype=torch.float32, device=device) + 0.5) / max(Hk - 1.0, 1.0) * 2.0 - 1.0
    xs = (torch.arange(Wk, dtype=torch.float32, device=device) + 0.5) / max(Wk - 1.0, 1.0) * 2.0 - 1.0
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)


def _pair(a: float, b: float, device) -> torch.Tensor:
    """The float32 pair (a, b), filled on ``device`` (``fill_`` takes a
    number; an assignment copies a host tensor): a host tensor's copy would
    wait for the stream, and a CUDA graph cannot capture it."""
    out = torch.empty(2, dtype=torch.float32, device=device)
    out[0].fill_(a)
    out[1].fill_(b)
    return out


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

    def runs_kernel(self, exact: bool = False) -> bool:
        """The JAX package's gate (``deformable_attention.py:243-252``
        there): the continuous bias, offsets on, attention dropout 0 or
        eval, and not under exact padded inference (``exact``: the block's
        map has per-sample extents, which K1 does not take; the composite
        masks them). Then K1 (and K2 under grad) computes the attention;
        else the composite."""
        return (self.use_pe and not (self.dwc_pe or self.fixed_pe or self.log_cpb)
                and not self.no_off and (self.attn_drop == 0.0 or not self.training)
                and not exact)

    def forward(self, x: torch.Tensor, batch: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H, W, C); ``batch`` (first row, data
        coordinate's batch size): x holds those batch rows of it."""
        with profiling.span("dat.attention"):
            return self._attend(x, batch)

    def _attend(self, x: torch.Tensor, batch: Optional[Tuple[int, int]]) -> torch.Tensor:
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

        # exact padded inference: the samples' true extents at this map
        ext_q = valid_extent.lookup((H, W))
        x = entering(x, ax)
        q = self.proj_q(x)
        q_g = grouped(q)
        offset = self.offset_proj(gelu(self.offset_ln(self.offset_dwc(q_g)))).float()
        Hk, Wk = offset.shape[1:3]
        Ns = Hk * Wk
        exact = None
        if ext_q is not None:
            if self.no_off:
                ext_kv = torch.div(ext_q, self.stride, rounding_mode="floor")
            else:
                k, s, p = self.offset_dwc.kernel_size[0], self.stride, self.offset_dwc.padding[0]
                ext_kv = valid_extent.conv_out_extent(ext_q, k, s, p)
            exact = (ext_q, ext_kv, (Hk, Wk))
        if self.no_off:
            # the net runs and its output is dropped, as in the JAX package
            offset = torch.zeros_like(offset)
        elif self.offset_range_factor >= 0:
            if exact is None:
                rng = _pair(1.0 / (Hk - 1.0), 1.0 / (Wk - 1.0), offset.device)
            else:  # over each sample's true kv extent
                rng = 1.0 / (ext_kv.float() - 1.0).clamp_min(1.0)
                rng = valid_extent.repeat_groups(rng, B * g)[:, None, None, :]
            offset = torch.tanh(offset) * rng * self.offset_range_factor
        if exact is None:
            ref = reference_points(Hk, Wk, x.device)
        else:
            ref = valid_extent.repeat_groups(_reference_points_ps(ext_kv, Hk, Wk), B * g)
        pos = offset + ref  # (B*g, Hk, Wk, 2), (y, x)
        if self.offset_range_factor < 0:
            pos = pos.clamp(-1.0, 1.0)
        if exact is not None:
            # the features beyond the true extent read as the exact run's
            # zeros padding; the positions, normalised over the true extent,
            # rescaled for the sampler's padded map
            x = valid_extent.mask_tensor(x, ext_q)
            sc = (ext_q.float() - 1.0) / _pair(max(H - 1.0, 1.0), max(W - 1.0, 1.0), x.device)
            grid = (pos + 1.0) * valid_extent.repeat_groups(sc, B * g)[:, None, None, :] - 1.0
        else:
            grid = pos

        if self.no_off:  # every channel: no gather
            sampled = avg_pool(x, self.stride, self.stride).reshape(B, Ns, C)
        else:
            xl = x if ax is None else mesh.slice_of(x, 3, ax)
            samp = grid_sample(grouped(xl), grid.flip(-1))  # grid in (x, y) order
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

        if not self.runs_kernel(exact is not None):
            profiling.count("attn.composite")
            out = self._composite(q, k, v, pos, H, W, batch, exact)
            return self.proj_drop(row_parallel(self.proj_out, out, ax), batch=batch)

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

    def _composite(self, q, k, v, pos, H: int, W: int, batch=None, exact=None) -> torch.Tensor:
        """The JAX package's composite (``deformable_attention.py:299-524``
        there) on q (B, H, W, C), k, v (B, Ns, C) and pos (B*g, Ns, 2): the
        products and the softmax in float32, P rounded to q's dtype for the
        dropout and P·V, the output in q's dtype, (B, H, W, C). ``exact``
        (ext_q, ext_kv, (Hk, Wk)) under exact padded inference: the bias
        at the true extents and the kv points beyond ``ext_kv`` out of the
        softmax. Over the model axis C and g are this rank's, and so are
        the heads and the dropout mask's."""
        B, _, _, C = q.shape
        ax = self.model_axis
        heads, Ns = self.n_heads // (1 if ax is None else ax.size), k.shape[1]
        hc = C // heads
        qh = q.reshape(B, H * W, heads, hc).float()
        kh = k.reshape(B, Ns, heads, hc).float()
        attn = torch.einsum("bmhc,bnhc->bhmn", qh, kh) * hc ** -0.5
        bias = self._bias(pos, B, H, W, exact, q.dtype)
        if bias is not None:
            attn = attn + bias
        if exact is not None:  # kv points beyond the true grid do not exist there
            kv_mask = valid_extent.mask_for(exact[2], exact[1], torch.bool).reshape(B, 1, 1, Ns)
            attn = torch.where(kv_mask, attn, attn.new_full((), -1e30))
        p = self.attn_dropout(torch.softmax(attn, dim=-1).to(q.dtype), ax, batch=batch,
                              channel_dim=1)
        out = torch.einsum("bhmn,bnhc->bmhc", p.float(), v.reshape(B, Ns, heads, hc).float())
        out = out.reshape(B, H, W, C).to(q.dtype)
        if hasattr(self, "rpe_dwc"):
            out = out + self.rpe_dwc(q)
        return out

    def _bias(self, pos: torch.Tensor, B: int, H: int, W: int, exact=None,
              dtype=torch.float32) -> Optional[torch.Tensor]:
        """The mode's position bias, float32, broadcastable to (B, heads,
        H*W, Ns) (this rank's groups and heads over the model axis); None
        for ``dwc_pe``, ``no_off`` and ``use_pe=False``. Under exact padded
        inference (``exact``) at each sample's true extents; ``dtype`` (the
        queries') is that of ``fixed_pe``'s tap-weight products there, as
        the JAX package's."""
        parts = 1 if self.model_axis is None else self.model_axis.size
        g, heads = self.n_groups // parts, self.n_heads // parts
        h_g, Ns = heads // g, pos.shape[1]
        if exact is not None:
            qy, qx = _query_grid_ps(exact[0], H, W, g)
        if hasattr(self, "cpb_fc1"):  # log_cpb
            if exact is None:
                qg = query_grid(H, W, pos.device).reshape(1, H * W, 1, 2)
            else:
                qg = torch.stack(torch.broadcast_tensors(qy[:, :, None], qx[:, None, :]), dim=-1)
                qg = qg.reshape(B * g, H * W, 1, 2)
            disp = (qg - pos[:, None]) * 4.0  # (B*g, H*W, Ns, 2)
            disp = (torch.sign(disp) * torch.log2(disp.abs() + 1.0)
                    / disp.new_full((), math.log2(8.0)))
            # float32, as flax's Dense promotes its bf16 weights to the
            # float32 displacements
            hb = F.relu(F.linear(disp, self.cpb_fc1.weight.float(), self.cpb_fc1.bias.float()))
            bias = F.linear(hb, self.cpb_fc2.weight.float())  # (B*g, H*W, Ns, h_g)
            return bias.reshape(B, g, H * W, Ns, h_g).permute(0, 1, 4, 2, 3).reshape(
                B, heads, H * W, Ns)
        if not hasattr(self, "rpe_table"):
            return None
        table = self.rpe_table
        if self.fixed_pe and exact is not None:
            return _fixed_pe_bias_ps(table, exact, H, W, dtype)
        if self.fixed_pe:
            # the reference's 2-d align-corners resize over the table's two
            # flat axes, in float32, the result in the table's dtype
            bias = resize_bilinear(table.float()[None].permute(0, 2, 3, 1), (H * W, Ns),
                                   align_corners=True)
            return bias.permute(0, 3, 1, 2).to(table.dtype).float()  # (1, heads, H*W, Ns)
        th, tw = table.shape[1:]
        table = table.reshape(g, h_g, th, tw)
        bias = rpe_bias(pos, table, H, W) if exact is None else rpe_bias_at(pos, table, qy, qx)
        return bias.reshape(B, heads, H * W, Ns)


def _reference_points_ps(ext_kv: torch.Tensor, Hk: int, Wk: int) -> torch.Tensor:
    """``reference_points`` over each sample's true kv extent ``ext_kv``
    (B, 2) on the padded (Hk, Wk) grid: (B, Hk, Wk, 2)."""
    hk = (ext_kv[:, 0].float() - 1.0).clamp_min(1.0)
    wk = (ext_kv[:, 1].float() - 1.0).clamp_min(1.0)
    dev = ext_kv.device
    ys = (torch.arange(Hk, dtype=torch.float32, device=dev) + 0.5)[None, :] / hk[:, None] * 2.0 - 1.0
    xs = (torch.arange(Wk, dtype=torch.float32, device=dev) + 0.5)[None, :] / wk[:, None] * 2.0 - 1.0
    return torch.stack(torch.broadcast_tensors(ys[:, :, None], xs[:, None, :]), dim=-1)


def _query_grid_ps(ext_q: torch.Tensor, H: int, W: int, g: int):
    """The query grid's rows (B*g, H) and columns (B*g, W) over each
    sample's true extent (corners of the extent at -1 and +1, as
    ``query_grid``), repeated over its groups."""
    hq = (ext_q[:, 0].float() - 1.0).clamp_min(1.0)
    wq = (ext_q[:, 1].float() - 1.0).clamp_min(1.0)
    dev = ext_q.device
    qy = torch.arange(H, dtype=torch.float32, device=dev)[None, :] / hq[:, None] * 2.0 - 1.0
    qx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] / wq[:, None] * 2.0 - 1.0
    return qy.repeat_interleave(g, dim=0), qx.repeat_interleave(g, dim=0)


def _fixed_pe_bias_ps(table: torch.Tensor, exact, H: int, W: int, dtype) -> torch.Tensor:
    """``fixed_pe``'s bias under exact padded inference (the JAX package's
    ``deformable_attention.py:327-385``): the reference resizes the (q_hw,
    kv_hw) table to the runtime (H*W, Ns) with a 2-d align-corners bilinear
    interpolation, separable over the two flat row-major axes; in the exact
    run those have per-sample lengths eh·ew and ekh·ekw, so each 1-d
    interpolation is a per-sample tap-weight product: padded query (y, x)
    is exact flat index y·ew + x, scaled by (q_hw - 1)/(eh·ew - 1). Invalid
    queries alias valid rows (discarded downstream); invalid kv columns
    leave the softmax. The weights in ``dtype``, the products summed in
    float32, the first rounded to ``dtype``: (B, heads, H*W, Ns)."""
    ext_q, ext_kv, (Hk, Wk) = exact
    q_hw, kv_hw = table.shape[1:]
    dev = ext_q.device

    def weights(ext, rows, cols, size):
        eh, ew = ext[:, 0].float(), ext[:, 1].float()
        yy = torch.arange(rows, dtype=torch.float32, device=dev)
        xx = torch.arange(cols, dtype=torch.float32, device=dev)
        flat = (yy[None, :, None] * ew[:, None, None] + xx[None, None, :]).reshape(-1, rows * cols)
        u = flat * (size - 1.0) / (eh * ew - 1.0).clamp_min(1.0)[:, None]
        return lerp_weight_matrix(u, size, dtype).float()

    w1 = weights(ext_q, H, W, q_hw)  # (B, H*W, q_hw)
    w2 = weights(ext_kv, Hk, Wk, kv_hw)  # (B, Ns, kv_hw)
    m1 = torch.einsum("bmp,hpq->bhmq", w1, table.to(dtype).float()).to(dtype).float()
    return torch.einsum("bhmq,bnq->bhmn", m1, w2)
