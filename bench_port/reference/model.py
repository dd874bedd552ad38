"""Plain PyTorch reference of the DAT++ segmentors the benchmark serves and
trains: DAT-T++ with SemanticFPN, and with UperNet and the FCN auxiliary
head. NHWC, float32; every operation a stock PyTorch one, and no kernel.

Built from a configuration file's ``model`` section (``bench_port/configs``),
never from the program: this module imports nothing of the port. Its
parameter and buffer names are the port's ``state_dict`` names, so that the
benchmark can make one set of weights from the seed and hand the same
tensors to both sides.

The deformable attention is written in its own words: the continuous
relative-position bias is ``F.grid_sample`` of each head's table at half
the query-to-sample displacement (align corners, zeros outside), and the
scores, the softmax and the product with the values are explicit. Drop path
and dropout draw from a ``torch.Generator`` handed to the model, in the
forward's order, one ``bernoulli_`` of a float32 tensor of the mask's shape
a draw, so that a step seeded alike draws the masks the program draws.

``quant`` (``Ctx.quant``): a function applied to every tensor the model
holds: the inputs, weights and outputs of every product (linear,
convolution, the attention's q, k, v and its output), every norm's and
activation's output and the residual stream. The control of the correctness
check sets it to a rounding through float8 (``float8_round``); ``None``
leaves float32 alone. ``attn_core`` replaces the attention core
``softmax(q kᵀ scale + bias) v`` (the FLOP count puts a stub there and
counts the core by its formula).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
SUPPORTED_OFF = ("dwc_pes", "fixed_pes", "no_offs", "use_cmt_mlps", "log_cpb")


class Ctx:
    """What every module of one reference model reads: the generator of its
    masks, the rounding of the control, the attention core."""

    def __init__(self):
        self.generator: Optional[torch.Generator] = None
        self.quant: Quant = None
        self.attn_core: Optional[Callable] = None

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant is None else self.quant(t)


class Linear(nn.Module):
    def __init__(self, ctx: Ctx, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.ctx = [ctx]
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        c = self.ctx[0]
        return c.q(F.linear(c.q(x), c.q(self.weight), self.bias))


class Conv(nn.Module):
    """A convolution of NHWC tensors; ``groups=channels`` is depthwise."""

    def __init__(self, ctx: Ctx, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.ctx = [ctx]
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        c = self.ctx[0]
        y = F.conv2d(c.q(x).permute(0, 3, 1, 2), c.q(self.weight), self.bias, self.stride,
                     self.padding, 1, self.groups)
        return c.q(y.permute(0, 2, 3, 1))


class LayerNorm(nn.Module):
    def __init__(self, ctx: Ctx, dim: int):
        super().__init__()
        self.ctx = [ctx]
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return self.ctx[0].q(F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5))


class BatchNorm(nn.Module):
    """BatchNorm of NHWC tensors: the batch's statistics (biased variance)
    in training, the running ones in eval."""

    def __init__(self, ctx: Ctx, dim: int):
        super().__init__()
        self.ctx = [ctx]
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)
        if self.training:
            mean = xc.mean((0, 2, 3), keepdim=True)
            var = (xc - mean).square().mean((0, 2, 3), keepdim=True)
        else:
            mean, var = self.running_mean[:, None, None], self.running_var[:, None, None]
        y = (xc - mean) * torch.rsqrt(var + 1e-5) * self.weight[:, None, None] \
            + self.bias[:, None, None]
        return self.ctx[0].q(y.permute(0, 2, 3, 1))


def draw_keep(ctx: Ctx, shape, rate: float, device) -> torch.Tensor:
    """A keep mask of ``shape``: one Bernoulli(1 - rate) draw of a float32
    tensor from the model's generator."""
    if ctx.generator is None:
        raise RuntimeError("a training forward draws its masks from a generator: set ctx.generator")
    mask = torch.empty(tuple(shape), device=device)
    mask.bernoulli_(1.0 - rate, generator=ctx.generator)
    return mask.bool()


class Drop(nn.Module):
    """Elementwise dropout (``per_sample=False``) or drop path (True)."""

    def __init__(self, ctx: Ctx, rate: float, per_sample: bool):
        super().__init__()
        self.ctx = [ctx]
        self.rate, self.per_sample = float(rate), per_sample

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1) if self.per_sample else x.shape
        keep = draw_keep(self.ctx[0], shape, self.rate, x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


class ConvMlp(nn.Module):
    """1x1 up, residual 3x3 depthwise, GELU, 1x1 down."""

    def __init__(self, ctx, dim, expansion):
        super().__init__()
        hidden = dim * expansion
        self.fc1 = Linear(ctx, dim, hidden)
        self.dwc = Conv(ctx, hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = Linear(ctx, hidden, dim)

    def forward(self, x):
        q = self.fc1.ctx[0].q
        x = self.fc1(x)
        return self.fc2(q(F.gelu(q(x + self.dwc(x)))))


def attention_core(q, k, v, pos, table, scale):
    """softmax(q kᵀ scale + bias) v for q (BG, H, W, Cg), k, v (BG, Ns, Cg),
    pos (BG, Ns, 2) normalised (y, x) and table (g, h_g, th, tw), heads of
    Cg / h_g channels. The bias of query (y, x) and sample n is head h's
    table read bilinearly at 0.5 * ((y, x) - pos[n]), where -1 and +1 are the
    table's first and last entries and entries outside it read zero."""
    BG, H, W, Cg = q.shape
    Ns = k.shape[1]
    g, h_g = table.shape[:2]
    hc = Cg // h_g
    qy = torch.arange(H, dtype=torch.float32, device=q.device) * (2.0 / max(H - 1, 1)) - 1.0
    qx = torch.arange(W, dtype=torch.float32, device=q.device) * (2.0 / max(W - 1, 1)) - 1.0
    qq = torch.stack(torch.meshgrid(qy, qx, indexing="ij"), -1).reshape(1, H * W, 1, 2)
    disp = (qq - pos[:, None, :, :]) * 0.5  # (BG, HW, Ns, 2) as (y, x)
    grid = disp.flip(-1)  # grid_sample reads (x, y)
    tables = table.reshape(1, g, h_g, *table.shape[2:]).expand(BG // g, -1, -1, -1, -1)
    tables = tables.reshape(BG, h_g, *table.shape[2:])
    bias = F.grid_sample(tables, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)  # (BG, h_g, HW, Ns)
    qh = q.reshape(BG, H * W, h_g, hc).permute(0, 2, 1, 3)
    kh = k.reshape(BG, Ns, h_g, hc).permute(0, 2, 3, 1)
    vh = v.reshape(BG, Ns, h_g, hc).permute(0, 2, 1, 3)
    p = torch.softmax(torch.matmul(qh, kh) * scale + bias, dim=-1)
    out = torch.matmul(p, vh)  # (BG, h_g, HW, hc)
    return out.permute(0, 2, 1, 3).reshape(BG, H, W, Cg)


class DeformableAttention(nn.Module):
    """DAT++'s deformable attention with the continuous position bias."""

    def __init__(self, ctx, dim, heads, groups, stride, ksize, q_size, offset_range_factor):
        super().__init__()
        self.ctx = [ctx]
        self.dim, self.heads, self.groups = dim, heads, groups
        self.offset_range_factor = offset_range_factor
        cg = dim // groups
        pad = ksize // 2 if ksize != stride else 0
        self.proj_q = Linear(ctx, dim, dim)
        self.offset_dwc = Conv(ctx, cg, cg, ksize, stride=stride, padding=pad, groups=cg)
        self.offset_ln = LayerNorm(ctx, cg)
        self.offset_proj = Linear(ctx, cg, 2, bias=False)
        self.proj_k = Linear(ctx, dim, dim)
        self.proj_v = Linear(ctx, dim, dim)
        self.proj_out = Linear(ctx, dim, dim)
        self.rpe_table = nn.Parameter(torch.empty(heads, 2 * q_size - 1, 2 * q_size - 1))

    def forward(self, x):
        ctx = self.ctx[0]
        B, H, W, C = x.shape
        g = self.groups
        cg, h_g = C // g, self.heads // g

        def grouped(t):  # (B, H, W, C) -> (B*g, H, W, cg)
            return t.reshape(B, H, W, g, cg).permute(0, 3, 1, 2, 4).reshape(B * g, H, W, cg)

        q = self.proj_q(x)
        q_g = grouped(q)
        off = self.offset_proj(ctx.q(F.gelu(self.offset_ln(self.offset_dwc(q_g)))))
        Hk, Wk = off.shape[1:3]
        Ns = Hk * Wk
        if self.offset_range_factor >= 0:
            rng = off.new_tensor([1.0 / (Hk - 1.0), 1.0 / (Wk - 1.0)])
            off = torch.tanh(off) * rng * self.offset_range_factor
        ry = (torch.arange(Hk, dtype=torch.float32, device=x.device) + 0.5) / max(Hk - 1.0, 1.0)
        rx = (torch.arange(Wk, dtype=torch.float32, device=x.device) + 0.5) / max(Wk - 1.0, 1.0)
        ref = torch.stack(torch.meshgrid(ry * 2 - 1, rx * 2 - 1, indexing="ij"), -1)
        pos = off + ref
        if self.offset_range_factor < 0:
            pos = pos.clamp(-1.0, 1.0)
        samp = F.grid_sample(grouped(x).permute(0, 3, 1, 2), pos.flip(-1), mode="bilinear",
                             padding_mode="zeros", align_corners=True)  # (B*g, cg, Hk, Wk)
        sampled = samp.reshape(B, g, cg, Ns).permute(0, 3, 1, 2).reshape(B, Ns, C)
        k, v = self.proj_k(sampled), self.proj_v(sampled)

        def by_group(t):  # (B, Ns, C) -> (B*g, Ns, cg)
            return t.reshape(B, Ns, g, cg).permute(0, 2, 1, 3).reshape(B * g, Ns, cg)

        core = ctx.attn_core or attention_core
        table = self.rpe_table.reshape(g, h_g, *self.rpe_table.shape[1:])
        out = ctx.q(core(ctx.q(q_g), ctx.q(by_group(k)), ctx.q(by_group(v)),
                         pos.reshape(B * g, Ns, 2), table, (C // self.heads) ** -0.5))
        out = out.reshape(B, g, H, W, cg).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj_out(out)


class Stage(nn.Module):
    def __init__(self, ctx, in_dim, dim, q_size, spec, bb, i, dpr):
        super().__init__()
        self.ctx = [ctx]
        self.spec = tuple(spec)
        if in_dim != dim:
            self.proj = Conv(ctx, in_dim, dim, 1)
        ws, exp = bb["window_sizes"][i], bb["expansion"]
        for d, kind in enumerate(self.spec):
            self.add_module(f"lpu_{d}", Conv(ctx, dim, dim, 3, padding=1, groups=dim))
            self.add_module(f"drop_path_{d}", Drop(ctx, dpr[d], True))
            if kind == "X":
                self.add_module(f"conv_attn_{d}", Conv(ctx, dim, dim, ws, padding=ws // 2,
                                                       groups=dim))
                self.add_module(f"ln_cnvnxt_{d}", LayerNorm(ctx, dim))
            else:
                self.add_module(f"norm1_{d}", LayerNorm(ctx, dim))
                self.add_module(f"attn_{d}", DeformableAttention(
                    ctx, dim, bb["heads"][i], bb["groups"][i], bb["strides"][i],
                    bb["ksizes"][i], q_size, bb["offset_range_factor"][i]))
                self.add_module(f"norm2_{d}", LayerNorm(ctx, dim))
            self.add_module(f"mlp_{d}", ConvMlp(ctx, dim, exp))

    def forward(self, x):
        q = self.ctx[0].q
        if hasattr(self, "proj"):
            x = self.proj(x)
        for d, kind in enumerate(self.spec):
            m = lambda n: getattr(self, f"{n}_{d}")  # noqa: E731
            x = q(x + m("lpu")(x))
            if kind == "X":  # DAT++'s X block has no residual around it
                x = m("drop_path")(m("mlp")(m("ln_cnvnxt")(m("conv_attn")(x))))
            else:
                x = q(m("drop_path")(m("attn")(m("norm1")(x))) + x)
                x = q(m("drop_path")(m("mlp")(m("norm2")(x))) + x)
        return x


class Backbone(nn.Module):
    """DAT++: the two-conv stem, four stages joined by stride-2 convs, a
    LayerNorm on each output."""

    def __init__(self, ctx, bb):
        super().__init__()
        for key in SUPPORTED_OFF:
            if any(bb[key]):
                raise NotImplementedError(f"the reference serves DAT++ presets: {key} is off there")
        if not (bb["use_conv_patches"] and all(bb["use_lpus"]) and all(bb["use_dwc_mlps"])
                and all(bb["use_pes"]) and all(v < 0 for v in bb["layer_scale_values"])
                and bb["drop_rate"] == 0 and bb["attn_drop_rate"] == 0):
            raise NotImplementedError("the reference serves DAT++ presets (conv patches, LPUs, "
                                      "DWC MLPs, the continuous bias, no layer scale or dropout)")
        ds, dims, depths = bb["dim_stem"], bb["dims"], bb["depths"]
        self.stem_conv1 = Conv(ctx, 3, ds // 2, 3, stride=bb["patch_size"] // 2, padding=1)
        self.stem_ln1 = LayerNorm(ctx, ds // 2)
        self.stem_conv2 = Conv(ctx, ds // 2, ds, 3, stride=bb["patch_size"] // 2, padding=1)
        self.stem_ln2 = LayerNorm(ctx, ds)
        total = sum(depths)
        dpr = [bb["drop_path_rate"] * i / max(total - 1, 1) for i in range(total)]
        fmap, in_dim = bb["img_size"] // bb["patch_size"], ds
        for i in range(4):
            self.add_module(f"stage_{i}", Stage(ctx, in_dim, dims[i], fmap, bb["stage_spec"][i],
                                                bb, i, dpr[sum(depths[:i]):sum(depths[:i + 1])]))
            self.add_module(f"out_norm_{i}", LayerNorm(ctx, dims[i]))
            if i < 3:
                self.add_module(f"down_conv_{i}", Conv(ctx, dims[i], dims[i + 1], 3, stride=2,
                                                       padding=1, bias=False))
                self.add_module(f"down_ln_{i}", LayerNorm(ctx, dims[i + 1]))
            fmap //= 2
            in_dim = dims[i + 1] if i < 3 else dims[i]

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem_ln2(self.stem_conv2(self.stem_ln1.ctx[0].q(F.gelu(self.stem_ln1(
            self.stem_conv1(x))))))
        outs = []
        for i in range(4):
            x = getattr(self, f"stage_{i}")(x)
            outs.append(getattr(self, f"out_norm_{i}")(x))
            if i < 3:
                x = getattr(self, f"down_ln_{i}")(getattr(self, f"down_conv_{i}")(x))
        return outs


def resize(x, hw, mode="bilinear"):
    """NHWC resize, half-pixel centres (``align_corners=False``)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    kw = {"align_corners": False} if mode == "bilinear" else {}
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode=mode, **kw).permute(0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    def __init__(self, ctx, cin, cout, k):
        super().__init__()
        self.conv = Conv(ctx, cin, cout, k, padding=k // 2, bias=False)
        self.bn = BatchNorm(ctx, cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class FPNNeck(nn.Module):
    def __init__(self, ctx, dims, out):
        super().__init__()
        self.n = len(dims)
        for i, c in enumerate(dims):
            self.add_module(f"lateral_{i}", Linear(ctx, c, out))
            self.add_module(f"fpn_{i}", Conv(ctx, out, out, 3, padding=1))

    def forward(self, feats):
        lat = [getattr(self, f"lateral_{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.n - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize(lat[i], lat[i - 1].shape[1:3], "nearest")
        return [getattr(self, f"fpn_{i}")(t) for i, t in enumerate(lat)]


class FPNHead(nn.Module):
    def __init__(self, ctx, cin, classes, channels, strides, dropout=0.1):
        super().__init__()
        self.lengths = [max(1, int(math.log2(s) - math.log2(strides[0]))) for s in strides]
        self.strides = tuple(strides)
        for i, n in enumerate(self.lengths):
            for k in range(n):
                self.add_module(f"scale_{i}_{k}", ConvBNReLU(ctx, cin if k == 0 else channels,
                                                             channels, 3))
        self.dropout = Drop(ctx, dropout, False)
        self.cls_seg = Linear(ctx, channels, classes)

    def forward(self, feats):
        out = None
        for i, n in enumerate(self.lengths):
            x = feats[i]
            for k in range(n):
                x = getattr(self, f"scale_{i}_{k}")(x)
                if self.strides[i] != self.strides[0]:
                    x = resize(x, (x.shape[1] * 2, x.shape[2] * 2))
            out = x if out is None else out + resize(x, out.shape[1:3])
        return self.cls_seg(self.dropout(out))


class UPerHead(nn.Module):
    """UperNet's head in mmseg's order: the PPM, 1x1 laterals, every
    top-down sum first, then each level's 3x3 conv, the fuse conv."""

    def __init__(self, ctx, dims, classes, channels, pool_scales=(1, 2, 3, 6), dropout=0.1):
        super().__init__()
        self.n, self.pool_scales = len(dims), tuple(pool_scales)
        pc = channels // len(pool_scales)
        for j in range(len(pool_scales)):
            self.add_module(f"ppm_{j}", ConvBNReLU(ctx, dims[-1], pc, 1))
        self.ppm_bottleneck = ConvBNReLU(ctx, dims[-1] + len(pool_scales) * pc, channels, 3)
        for i in range(self.n - 1):
            self.add_module(f"lateral_{i}", ConvBNReLU(ctx, dims[i], channels, 1))
            self.add_module(f"fpn_{i}", ConvBNReLU(ctx, channels, channels, 3))
        self.fuse_bottleneck = ConvBNReLU(ctx, self.n * channels, channels, 3)
        self.dropout = Drop(ctx, dropout, False)
        self.cls_seg = Linear(ctx, channels, classes)

    def forward(self, feats):
        deep = feats[-1]
        ppm = [deep]
        for j, s in enumerate(self.pool_scales):
            pooled = F.adaptive_avg_pool2d(deep.permute(0, 3, 1, 2), (s, s)).permute(0, 2, 3, 1)
            ppm.append(resize(getattr(self, f"ppm_{j}")(pooled), deep.shape[1:3]))
        lat = [getattr(self, f"lateral_{i}")(feats[i]) for i in range(self.n - 1)]
        lat.append(self.ppm_bottleneck(torch.cat(ppm, -1)))
        for i in range(self.n - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize(lat[i], lat[i - 1].shape[1:3])
        outs = [getattr(self, f"fpn_{i}")(lat[i]) for i in range(self.n - 1)] + [lat[-1]]
        outs = [outs[0]] + [resize(o, outs[0].shape[1:3]) for o in outs[1:]]
        return self.cls_seg(self.dropout(self.fuse_bottleneck(torch.cat(outs, -1))))


class FCNHead(nn.Module):
    def __init__(self, ctx, cin, classes, channels, dropout=0.1):
        super().__init__()
        self.conv_0 = ConvBNReLU(ctx, cin, channels, 3)
        self.dropout = Drop(ctx, dropout, False)
        self.cls_seg = Linear(ctx, channels, classes)

    def forward(self, x):
        return self.cls_seg(self.dropout(self.conv_0(x)))


class Segmentor(nn.Module):
    """Backbone, optional FPN neck, decode head; in training with an
    auxiliary head also its logits. ``forward`` returns stride-4 logits
    (``upsample=False``) or logits at the input size."""

    def __init__(self, model_cfg: dict):
        super().__init__()
        ctx = self.ctx = Ctx()
        bb = model_cfg["backbone"]
        dims = bb["dims"]
        self.backbone = Backbone(ctx, bb)
        neck, dec, aux = model_cfg["neck"], model_cfg["decode_head"], model_cfg["auxiliary_head"]
        self.neck = FPNNeck(ctx, dims, neck["out_channels"]) if neck else None
        if dec["type"] == "FPNHead":
            self.decode_head = FPNHead(ctx, neck["out_channels"], dec["num_classes"],
                                       dec["channels"], dec["kwargs"]["feature_strides"])
        elif dec["type"] == "UPerHead":
            self.decode_head = UPerHead(ctx, dims, dec["num_classes"], dec["channels"])
        else:
            raise NotImplementedError(f"decode head {dec['type']}")
        self.aux_in = model_cfg["aux_in_index"]
        self.auxiliary_head = None
        if aux is not None:
            if aux["type"] != "FCNHead":
                raise NotImplementedError(f"auxiliary head {aux['type']}")
            self.auxiliary_head = FCNHead(ctx, dims[self.aux_in], aux["num_classes"],
                                          aux["channels"])

    def forward(self, x, upsample: bool = True):
        feats = self.backbone(x)
        logits = self.decode_head(self.neck(feats) if self.neck is not None else feats)
        logits = self.ctx.q(logits)
        if upsample:
            logits = resize(logits, x.shape[1:3])
        if self.training and self.auxiliary_head is not None:
            aux = resize(self.ctx.q(self.auxiliary_head(feats[self.aux_in])), x.shape[1:3])
            return logits, aux
        return logits


def _round8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round8(t)

    @staticmethod
    def backward(ctx, g):
        return _round8(g)


def float8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 (e4m3) with one scale for the tensor, its
    largest magnitude at float8's largest (448), as float8 compute holds its
    tensors; in the backward the gradient is rounded the same way."""
    return _Float8.apply(t)
