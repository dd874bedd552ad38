"""Core building blocks of the DAT model family, in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/layers.py``. Activations stay
NHWC as in the JAX package: a convolution runs on an NCHW view of the NHWC
tensor (channels-last memory, which cuDNN takes without a copy), and a 1x1
projection is an ``nn.Linear`` over the trailing channel axis. Parameter
names follow the JAX tree, so ``utils/convert.py`` maps one onto the other
by name. The torch default initialisers are the ones the JAX package
copied (kaiming-uniform with a = sqrt(5)), so nothing is re-declared here.

GELU is the exact erf form (``nn.GELU``'s default), as in the reference.

Randomness in training (``DropPath``, ``Dropout``) draws from a
``torch.Generator`` that the caller owns and hands to every such module
with ``use_generator``; the global RNG is used nowhere, so a train step is
reproducible from its seed. ``BatchNorm2d`` keeps its running statistics
as the JAX package's flax BatchNorm does (biased variance).

Over the mesh's spatial axis (``parallel/spatial.py``) a module given
``rows`` (a ``Rows``) takes a row shard of its input: ``Conv2d`` fetches
its kernel's halo, ``BatchNorm2d`` reduces over data × spatial (of this
rank's model coordinate) and ``Dropout`` keeps its rows of the data
coordinate's whole mask. Beside the model axis a split MLP runs on row
shards of its hidden units: ``dwc`` fetches its halo on this rank's
channels, the CMT BatchNorms take those channels' statistics over the
same group, and the masks are cut from the whole rows and width. A
module owning a parameter held as a slice over the model axis (the JAX
layout of a leaf no split rule covers) gathers it for each call
(``gather_at_use``), before a row shard's halo exchange.

Under exact padded inference (``ops/valid_extent.py``) every ``Conv2d``
on a whole map masks its input and output beyond the per-sample valid
extent and registers its output's extent, as the JAX package's
``conv2d`` (``models/layers.py:112-146`` there). Every spatial conv of the
eval path is a ``Conv2d``: the stem, the downsampling convs, the LPUs,
``offset_dwc``, ``rpe_dwc``, the MLPs' ``dwc`` and the heads' convs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import valid_extent
from ..parallel import mesh, spatial
from ..parallel.mesh import all_reduce, is_distributed, process_shard_info
from ..parallel.spatial import Rows


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors; ``groups=channels`` is depthwise.

    On a row shard (``rows``) it fetches the input rows its output rows
    (``out_rows``) read, zeros beyond the image as the padding, and
    convolves them unpadded in H: the halo of a stride-1 conv, the rows of
    a stride-s conv on the output's layout. A peer without output rows
    convolves one and keeps none (``parallel/spatial.py``: every peer runs
    the same operations)."""

    def out_rows(self, rows: Optional[Rows]) -> Optional[Rows]:
        """The layout of the output of an input on ``rows`` (None: None)."""
        if rows is None:
            return None
        (k, s, p) = self.kernel_size[0], self.stride[0], self.padding[0]
        return rows.at((rows.H + 2 * p - k) // s + 1)

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        if rows is None:
            ctx = valid_extent.current()
            ext = None if ctx is None else ctx.get(x.shape[1:3])
            if ext is None:
                return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            return self._exact(x, ctx, ext)
        out = self.out_rows(rows)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]

        def want(r):
            lo, hi = out.span(r)
            return lo * s - p, (lo + max(hi - lo, 1) - 1) * s - p + k

        xs = spatial.fetch(x, rows, want).permute(0, 3, 1, 2)
        y = F.conv2d(xs, self.weight, self.bias, self.stride, (0, self.padding[1]),
                     self.dilation, self.groups)
        return y[:, :, :out.n].permute(0, 2, 3, 1)

    def _exact(self, x: torch.Tensor, ctx: valid_extent.ExtentMap,
               ext: torch.Tensor) -> torch.Tensor:
        """Under exact padded inference (``ops/valid_extent.py``), as the JAX
        package's ``conv2d``: the input zeroed beyond its samples' extents,
        so that windows at the true border read the zeros the exact run's
        padding gives; the output's extent, by this conv's k/s/p,
        registered for what follows; the output zeroed beyond it."""
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        ext_out = valid_extent.conv_out_extent(ext, k, s, p)
        y = super().forward(valid_extent.mask_tensor(x, ext).permute(0, 3, 1, 2))
        y = y.permute(0, 2, 3, 1)
        ctx.register(y.shape[1:3], ext_out)
        return valid_extent.mask_tensor(y, ext_out)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channel axis of an NHWC tensor (eps 1e-5, the
    PyTorch default).

    The reference's ``LayerNormProxy`` without its NCHW<->NHWC rearranges.
    PyTorch takes the statistics in float32 for bf16 inputs, as the JAX
    package does.
    """


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm on NHWC tensors as the JAX package's ``batch_norm`` (flax
    BatchNorm, momentum 0.9 there and 0.1 here, eps 1e-5).

    In training it takes one set of batch statistics, as flax does:
    ``torch.native_batch_norm`` computes the mean and the **biased**
    variance once, in float32 (also for bf16 inputs, whose affine it then
    takes in float32), normalises with them, (x - mean) * rsqrt(var + eps)
    * weight + bias, and returns the mean and rsqrt(var + eps), from which
    ``running_mean`` and ``running_var`` move. ``nn.BatchNorm2d`` would
    move ``running_var`` towards the unbiased variance, n/(n-1) times
    larger: twice as large for the PPM's 1x1 pool at batch 2. Flax's
    E[x²] - E[x]² equals the variance up to rounding but cancels where
    |mean| >> std, so that the card and the CPU, summing in other orders,
    drift apart; PyTorch's kernels do not take that form. In eval it is
    ``nn.BatchNorm2d``.

    Inside a process group the statistics are the global batch's, as the
    JAX package's under GSPMD (``_GlobalBatchNorm``): two all-reduces over
    the data group (over data × spatial for a row shard, ``rows``; a
    replicated tensor beside a spatial axis takes the data group's), the sum with the count and then the sum of squared
    deviations from the global mean (no E[x²] - E[x]² either), and one in
    the backward; the running statistics come out the same on every
    process. A BatchNorm of channels split over the model axis holds this
    rank's channels and takes their statistics the same way.
    (``nn.SyncBatchNorm`` refuses CPU tensors.)
    """

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        if not self.training:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dt = torch.promote_types(x.dtype, torch.float32)
        if is_distributed():
            y, mean, var = _GlobalBatchNorm.apply(
                x.permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt), self.eps,
                rows is not None)
            self._track(mean, var)
            return y.permute(0, 2, 3, 1)
        y, mean, rstd = torch.native_batch_norm(
            x.permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt), None, None, True,
            0.0, self.eps,
        )
        with torch.no_grad():
            self._track(mean, (rstd.pow(-2) - self.eps).clamp_min(0.0))
        return y.permute(0, 2, 3, 1)

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1.0 - m) * self.running_var + m * var)
        self.num_batches_tracked += 1


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm of an NCHW view over the global batch of the
    process group: the output and the biased (mean, var) of every
    process's channels together. The backward's dx takes the global sums of
    dy and dy * x_hat (one all-reduce); the affine's gradients are this
    process's share, which the step sums with the others'. Only x (as the
    plain BatchNorm) and the per-channel statistics are kept for it.
    ``rows``: x is a row shard, reduced over data × spatial."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, rows):
        c = x.shape[1]
        acc = torch.promote_types(x.dtype, torch.float32)  # float32, or float64
        n = torch.tensor([x.numel() // c], dtype=acc, device=x.device)
        s = all_reduce(torch.cat([x.sum((0, 2, 3), dtype=acc), n]), rows=rows)
        count = s[c]
        mean = s[:c] / count
        m2 = all_reduce((x.to(acc) - mean[:, None, None]).square().sum((0, 2, 3)), rows=rows)
        var = m2 / count
        rstd = torch.rsqrt(var + eps)
        # eval-mode batch norm with the global statistics: one pass, x's dtype
        y = torch.native_batch_norm(x, weight, bias, mean, var, False, 0.0, eps)[0]
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.count, ctx.rows = count, rows
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        c = x.shape[1]
        g = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean[:, None, None]) * rstd[:, None, None]
        local = torch.cat([g.sum((0, 2, 3)), (g * xhat).sum((0, 2, 3))])
        dbias, dweight = local[:c].clone(), local[c:].clone()
        s = all_reduce(local, rows=ctx.rows) / ctx.count
        dx = (g - s[:c, None, None] - xhat * s[c:, None, None]) * (weight * rstd)[:, None, None]
        return dx.to(x.dtype), dweight, dbias, None, None


class Dropout(nn.Module):
    """Elementwise dropout (flax ``nn.Dropout``, which the JAX package's
    heads use, not mmseg's channel-wise ``Dropout2d``): x / keep where a
    Bernoulli(keep) mask drawn from ``self.generator`` keeps it, else 0.
    Identity in eval or at rate 0. Over a data axis of X processes each
    draws the mask of the global batch (X times its own rows, the leading
    axis) and keeps its rows, so the masks are the one-process step's at
    the global batch; on a tensor whose last axis is this rank's slice of
    the channels (``channels``: the model axis) it keeps that slice of the
    whole width's mask too, on a row shard (``rows``) its image rows, and
    on whole maps of part of the data coordinate's batch (``batch``: the
    first row and the data coordinate's batch size) those batch rows."""

    rows_in_mask = True  # the mask has the tensor's rows (drop path's has 1)

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None  # set by use_generator

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor, channels: Optional[mesh.ModelAxis] = None,
                rows: Optional[Rows] = None, batch: Optional[Tuple[int, int]] = None,
                channel_dim: int = -1) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "dropout and drop path draw from a torch.Generator the caller owns; "
                "hand one to the model with layers.use_generator(model, generator)"
            )
        keep = 1.0 - self.rate
        shape = list(self.mask_shape(x))
        rank, world = process_shard_info()
        cdim = channel_dim % len(shape)
        # drop path's mask broadcasts over the channels: one for every slice
        parts = 1 if channels is None or shape[cdim] != x.shape[cdim] else channels.size
        first, B = batch if batch is not None else (0, shape[0])
        # inside a process group: the global batch's mask (the generator is
        # seeded alike on every process), this process's rows of it (and
        # its channels along ``channel_dim``, its image rows)
        whole = [B * world] + shape[1:]
        whole[cdim] *= parts
        if rows is not None and self.rows_in_mask:
            whole[1] = rows.H
        mask = torch.empty(whole, device=x.device)
        mask.bernoulli_(keep, generator=self.generator)
        start = rank * B + first
        mask = mask[start:start + shape[0]]
        if rows is not None and self.rows_in_mask:
            mask = mask[:, rows.lo:rows.hi]
        if parts > 1:
            mask = mesh.slice_of(mask, cdim, channels)
        return torch.where(mask.bool(), x / keep, 0.0).to(x.dtype)


class DropPath(Dropout):
    """Per-sample stochastic depth (timm semantics, the JAX ``DropPath``):
    each sample is kept and scaled by 1/keep, or zeroed, as a whole."""

    rows_in_mask = False

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0],) + (1,) * (x.ndim - 1)


def use_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every ``Dropout`` and ``DropPath`` of ``model`` draw from
    ``generator`` (on the model's device)."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


class LayerScale(nn.Module):
    """Per-channel learnable gamma (reference dat.py:22-31)."""

    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


def row_parallel(linear: nn.Linear, x: torch.Tensor,
                 axis: Optional[mesh.ModelAxis]) -> torch.Tensor:
    """``linear(x)``; over a model axis, with this rank's slice of the input
    features: the partial products summed over the peers, then the bias
    (whole) added once."""
    if axis is None:
        return linear(x)
    y = mesh.reduce_from_model(F.linear(x, linear.weight), axis)
    return y if linear.bias is None else y + linear.bias


def entering(x: torch.Tensor, axis: Optional[mesh.ModelAxis]) -> torch.Tensor:
    """``x`` as it enters a module split over ``axis`` (``copy_to_model``)."""
    return x if axis is None else mesh.copy_to_model(x, axis)


def gather_at_use(module: nn.Module, leaves) -> None:
    """Make ``module`` gather the parameters ``leaves`` (name -> (axis, dim,
    partial)), of which this rank holds a slice along ``dim``, for each of
    its calls: a forward pre-hook puts the peers' slices joined
    (``mesh.gather_model``) in the slice's place, so the module computes on
    the whole parameter, and a forward hook puts the slice back. The
    state_dict keeps its names and the slices. What reads the whole
    parameter is replicated compute, so the backward takes this rank's
    slice of the gradient; a ``partial`` leaf's gradient, a part on each
    peer, is summed over the peers first. Under ``torch.func.
    functional_call`` the hooks gather the tensor the call swapped in (a
    cast copy, a checkpoint's saved slice), so a recompute gathers again.
    ``whole_param`` gives the whole outside the module's call."""
    module.gathered_at_use = dict(leaves)
    module.register_forward_pre_hook(_gather_leaves)
    module.register_forward_hook(_restore_slices, always_call=True)


def _gather_leaves(module, args):
    module._held_slices = {}
    for leaf, (axis, dim, partial) in module.gathered_at_use.items():
        t = module._parameters[leaf]
        module._held_slices[leaf] = t
        module._parameters[leaf] = mesh.gather_model(t, axis, dim, split_consumer=partial)


def _restore_slices(module, args, out):
    for leaf, t in module.__dict__.pop("_held_slices", {}).items():
        module._parameters[leaf] = t


def whole_param(module: nn.Module, leaf: str) -> torch.Tensor:
    """``module``'s parameter ``leaf`` whole: gathered over the model axis
    where this rank holds a slice of it and the module's own call has not
    (``gather_at_use``), as it is otherwise (K3 reads its blocks' weights
    without calling their modules)."""
    t = getattr(module, leaf)
    spec = getattr(module, "gathered_at_use", {}).get(leaf)
    if spec is None or leaf in getattr(module, "_held_slices", {}):
        return t
    axis, dim, partial = spec
    return mesh.gather_model(t, axis, dim, split_consumer=partial)


class Mlp(nn.Module):
    """Token MLP (reference ``TransformerMLP``). Over the model axis
    (``parallel/model_axis.py``) ``fc1`` holds this rank's hidden units and
    ``fc2`` their columns."""

    model_axis: Optional[mesh.ModelAxis] = None

    def __init__(self, dim: int, expansion: int = 4, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * expansion)
        self.fc2 = nn.Linear(dim * expansion, dim)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        ax = self.model_axis
        x = self.drop(gelu(self.fc1(entering(x, ax))), ax, rows)
        return self.drop(row_parallel(self.fc2, x, ax), rows=rows)


class ConvMlp(nn.Module):
    """DAT++'s depthwise-conv MLP (``use_dwc_mlps``): 1x1 up, residual 3x3
    depthwise, GELU, 1x1 down (reference ``TransformerMLPWithConv``); split
    as ``Mlp``, ``dwc`` by channel."""

    model_axis: Optional[mesh.ModelAxis] = None

    def __init__(self, dim: int, expansion: int = 4, drop: float = 0.0):
        super().__init__()
        hidden = dim * expansion
        self.fc1 = nn.Linear(dim, hidden)
        self.dwc = Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        ax = self.model_axis
        x = self.drop(self.fc1(entering(x, ax)), ax, rows)
        x = gelu(x + self.dwc(x, rows))
        return self.drop(row_parallel(self.fc2, x, ax), rows=rows)

    def whole_weights(self):
        """(fc1 w, b, dwc w, b, fc2 w, b) whole: over the model axis the
        slices gathered for replicated compute (K3)."""
        ax = self.model_axis
        ws = (self.fc1.weight, self.fc1.bias, self.dwc.weight, self.dwc.bias, self.fc2.weight)
        if ax is not None:
            ws = tuple(mesh.gather_model(w, ax, d) for w, d in zip(ws, (0, 0, 0, 0, 1)))
        else:  # unsplit (Y does not divide the hidden width): a weight may still be held
            ws = (whole_param(self.fc1, "weight"), ws[1], whole_param(self.dwc, "weight"), ws[3],
                  whole_param(self.fc2, "weight"))
        return ws + (self.fc2.bias,)


class CmtConvMlp(nn.Module):
    """CMT-style conv MLP with BatchNorms (reference
    ``TransformerMLPWithConv_CMT``); split as ``ConvMlp``, ``bn1``/``bn2`` by
    channel."""

    model_axis: Optional[mesh.ModelAxis] = None

    def __init__(self, dim: int, expansion: int = 4, drop: float = 0.0):
        super().__init__()
        hidden = dim * expansion
        self.fc1 = nn.Linear(dim, hidden)
        self.bn1 = BatchNorm2d(hidden)
        self.dwc = Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.bn2 = BatchNorm2d(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.bn3 = BatchNorm2d(dim)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        ax = self.model_axis
        x = self.drop(self.bn1(gelu(self.fc1(entering(x, ax))), rows), ax, rows)
        x = self.bn2(gelu(x + self.dwc(x, rows)), rows)
        return self.drop(self.bn3(row_parallel(self.fc2, x, ax), rows), rows=rows)
