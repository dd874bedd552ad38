"""DAT / DAT++ hierarchical backbone (4-stage pyramid), in PyTorch.

Counterpart of ``dat_segmentation_tpu/models/dat.py``. Per stage: an
optional 1x1 input projection, then ``depths`` blocks chosen by
``stage_spec`` -- 'D' is the deformable attention block (pre-LN residual
with LayerScale and DropPath), 'X' the ConvNeXt-like depthwise block -- each
preceded by the optional local perception unit (residual 3x3 depthwise).
Stride-2 convolutions join the stages; each output index has its own
LayerNorm.

Kept from the reference, as in the JAX package:
* 'X' blocks have no residual around the conv/MLP pair;
* the position-bias tables are sized from the config-time ``img_size``
  (224), not the runtime input size.

``kernel_impl='pallas'`` runs the fused X-block kernel K3
(``ops/x_block.py``) where the JAX package's gate lets it
(``models/dat.py:103-118`` there), decided per stage at the stage's true
H, W: a ConvMLP stage (``use_dwc_mlp``, not CMT), dropout 0 or eval, and
H and W multiples of 8; and within the CUDA kernel's own limits
(``ops/x_block.py``: C a multiple of ``CHANNEL_MULTIPLE`` up to
``MAX_CHANNELS``, the hidden width a multiple of ``HIDDEN_MULTIPLE``, an
'X' block's window in ``WINDOWS``), so that a config the JAX package runs
never makes the kernel refuse it. Then an 'X' block is one kernel (its LPU
included, so the separate LPU is skipped) and a 'D' block's second half
(LN + ConvMLP) is another, in MLP-only mode. Over the mesh's model axis
(``parallel/model_axis.py``) K3 takes the MLP's weights gathered from the
peers' slices (``ConvMlp.whole_weights``) and an X block's ``conv_attn``
whole (``layers.whole_param``: at the B++ widths it is held as a slice),
replicated compute whose backward gives each peer its slice of the
weights' gradient. Any other ``kernel_impl``
('xla', 'auto', 'gather') is the unfused chain, as the JAX package runs
on every backend but the TPU. The JAX package's TPU switch
``DAT_TPU_XBLOCK`` has no counterpart; its exact-extent clause is kept:
under exact padded inference (``ops/valid_extent.py``) no stage fuses,
whatever ``kernel_impl`` says. K1 (the deformable attention)
runs on the card whatever ``kernel_impl`` says, in each 'D' block whose
position-bias mode the JAX gate gives it (``DeformableAttention.
runs_kernel``: the continuous bias, offsets on, attention dropout 0 or
eval); the other blocks run the plain composite.

Over the mesh's spatial axis (``parallel/spatial.py``) ``DAT.forward``
takes a row shard of the image (``rows``) and returns each output's row
shard and layout: the stem's, the down convs' and the depthwise convs'
halos come from ``Conv2d``; each 'D' block's attention runs batch-parallel
on whole maps (``TransformerStage._attend``: the rows <-> batch all-to-all,
or every row gathered where S does not divide the batch), so the offsets
sample the whole map and K1/K2 see the one-process step's shapes; K3 runs
on a slab of the peer's rows and the halo it spoils (``spatial.slab``: 1 +
window // 2 + 1 rows for an 'X' block with its LPU, 1 for an MLP), gated
at the stage's global size. Both axes together: the attention's whole maps
split by offset group over the model peers, which hold the same batch
rows, and K3 on slabs with the MLP weights gathered over the model group;
a checkpointed stage's recompute issues both axes' collectives again in
the forward's order.

``use_checkpoint`` recomputes each stage's activations in the backward
during training (``torch.utils.checkpoint``), one stage at a time as the
JAX package's ``nn.remat`` over ``TransformerStage`` (``models/dat.py:
288-293`` there), also under FSDP2: the numbers do not change, the
activations held do.

Submodules carry the JAX package's names (``lpu_0``, ``attn_1``, ...), so
its variables map onto this state_dict by name (``utils/convert.py``).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops import valid_extent
from ..ops.x_block import (CHANNEL_MULTIPLE, HIDDEN_MULTIPLE, MAX_CHANNELS, WINDOWS,
                           fused_conv_mlp, fused_x_block)
from ..parallel import spatial
from ..parallel.mesh import is_sharded
from ..parallel.spatial import Rows
from .deformable_attention import DeformableAttention
from .layers import (CmtConvMlp, Conv2d, ConvMlp, DropPath, Dropout, LayerNorm2d, LayerScale,
                     Mlp, gelu, whole_param)


class TransformerStage(nn.Module):
    """One pyramid stage (reference dat.py:34-165)."""

    def __init__(
        self,
        in_dim: int,
        fmap_size: Tuple[int, int],
        window_size: int,
        dim_embed: int,
        depths: int,
        stage_spec: Sequence[str],
        n_groups: int,
        use_pe: bool,
        heads: int,
        stride: int,
        offset_range_factor: float,
        dwc_pe: bool,
        no_off: bool,
        fixed_pe: bool,
        attn_drop: float,
        proj_drop: float,
        expansion: int,
        drop: float,
        drop_path_rates: Sequence[float],
        use_dwc_mlp: bool,
        ksize: int,
        layer_scale_value: float,
        use_lpu: bool,
        use_cmt_mlp: bool,
        log_cpb: bool,
        kernel_impl: str = "xla",
    ):
        super().__init__()
        dim = dim_embed
        self.depths = depths
        self.stage_spec = tuple(stage_spec)
        self.use_lpu = use_lpu
        self.layer_scale = layer_scale_value > 0
        self.window_size = window_size
        self.drop = drop
        # the shape-free clauses of the JAX gate (dat.py:105-110 there), and
        # the CUDA kernel's own limits (ops/x_block.py:_check): a stage
        # outside them runs the unfused chain
        self.fusable = (
            kernel_impl == "pallas" and use_dwc_mlp and not use_cmt_mlp
            and dim % CHANNEL_MULTIPLE == 0 and dim <= MAX_CHANNELS
            and (dim * expansion) % HIDDEN_MULTIPLE == 0
            and ("X" not in self.stage_spec or window_size in WINDOWS)
        )
        if in_dim != dim:
            self.proj = Conv2d(in_dim, dim, 1)
        if use_dwc_mlp:
            mlp_cls = CmtConvMlp if use_cmt_mlp else ConvMlp
        else:
            mlp_cls = Mlp
        for d in range(depths):
            spec = self.stage_spec[d]
            if use_lpu:
                self.add_module(f"lpu_{d}", Conv2d(dim, dim, 3, padding=1, groups=dim))
            self.add_module(f"drop_path_{d}", DropPath(drop_path_rates[d]))
            if spec == "X":
                self.add_module(
                    f"conv_attn_{d}",
                    Conv2d(dim, dim, window_size, padding=window_size // 2, groups=dim),
                )
                self.add_module(f"ln_cnvnxt_{d}", LayerNorm2d(dim))
                self.add_module(f"mlp_{d}", mlp_cls(dim, expansion, drop))
            elif spec == "D":
                self.add_module(f"norm1_{d}", LayerNorm2d(dim))
                self.add_module(
                    f"attn_{d}",
                    DeformableAttention(
                        dim, heads, n_groups, stride, ksize, fmap_size,
                        offset_range_factor=offset_range_factor,
                        use_pe=use_pe, dwc_pe=dwc_pe, fixed_pe=fixed_pe,
                        log_cpb=log_cpb, no_off=no_off,
                        attn_drop=attn_drop, proj_drop=proj_drop,
                    ),
                )
                self.add_module(f"norm2_{d}", LayerNorm2d(dim))
                self.add_module(f"mlp_{d}", mlp_cls(dim, expansion, drop))
                if self.layer_scale:
                    self.add_module(f"ls1_{d}", LayerScale(dim, layer_scale_value))
                    self.add_module(f"ls2_{d}", LayerScale(dim, layer_scale_value))
            else:
                raise NotImplementedError(f"stage_spec {spec!r} not supported")

    def _block(self, name: str, d: int) -> nn.Module:
        return getattr(self, f"{name}_{d}")

    def fuses(self, H: int, W: int) -> bool:
        """The JAX gate at this stage's true size, within the kernel's
        limits: K3 runs here. Not under exact padded inference, whose
        per-sample extents the kernel does not take (the JAX gate's
        ``_ve.current() is None``, ``models/dat.py:111-113`` there): the
        unfused chain's convs mask them."""
        return (self.fusable and (self.drop == 0.0 or not self.training)
                and H % 8 == 0 and W % 8 == 0 and valid_extent.current() is None)

    @staticmethod
    def _on_slab(fn, x: torch.Tensor, rows: Optional[Rows], halo: int) -> torch.Tensor:
        """``fn`` (K3) on ``x``, or on a row shard's slab with ``halo`` rows
        that K3 spoils, of which this peer's rows are kept."""
        if rows is None:
            return fn(x)
        xs, keep = spatial.slab(x, rows, halo)
        return fn(xs)[:, keep]

    def _fused_x(self, x: torch.Tensor, d: int, rows: Optional[Rows] = None) -> torch.Tensor:
        lpu = self._block("lpu", d) if self.use_lpu else None
        conv, ln, mlp = (self._block(n, d) for n in ("conv_attn", "ln_cnvnxt", "mlp"))
        halo = int(self.use_lpu) + self.window_size // 2 + 1  # LPU, window, the MLP's dw3
        return self._on_slab(lambda t: fused_x_block(
            t, None if lpu is None else lpu.weight, None if lpu is None else lpu.bias,
            whole_param(conv, "weight"), conv.bias, ln.weight, ln.bias, *mlp.whole_weights(),
            self.window_size, self.use_lpu,
        ), x, rows, halo)

    def _fused_mlp(self, x: torch.Tensor, d: int, rows: Optional[Rows] = None) -> torch.Tensor:
        ln, mlp = self._block("norm2", d), self._block("mlp", d)
        return self._on_slab(lambda t: fused_conv_mlp(t, ln.weight, ln.bias,
                                                      *mlp.whole_weights()), x, rows, 1)

    def _attend(self, d: int, x: torch.Tensor, rows: Optional[Rows]) -> torch.Tensor:
        """The 'D' block's attention on ``x``; on a row shard batch-parallel
        over the spatial peers on whole maps: each peer takes B / S batch
        rows (the rows <-> batch all-to-all), or where S does not divide B
        every row of every batch row, keeping its own rows."""
        attn = self._block("attn", d)
        if rows is None:
            return attn(x)
        S, B = rows.axis.size, x.shape[0]
        if B % S:
            return spatial.keep_rows(attn(spatial.gather_rows(x, rows)), rows)
        b = B // S
        return spatial.from_batch(attn(spatial.to_batch(x, rows), batch=(rows.axis.rank * b, B)),
                                  rows)

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
        if hasattr(self, "proj"):
            x = self.proj(x, rows)
        fuse = self.fuses(x.shape[1] if rows is None else rows.H, x.shape[2])
        for d in range(self.depths):
            drop_path = self._block("drop_path", d)
            spec = self.stage_spec[d]
            if self.use_lpu and not (fuse and spec == "X"):  # K3 applies an X block's LPU
                x = x + self._block("lpu", d)(x, rows)
            if spec == "X":
                # ConvNeXt-like block; deliberately no residual (see header)
                if fuse:
                    y = self._fused_x(x, d, rows)
                else:
                    y = self._block("conv_attn", d)(x, rows)
                    y = self._block("mlp", d)(self._block("ln_cnvnxt", d)(y), rows)
                x = drop_path(y)
            else:
                y = self._attend(d, self._block("norm1", d)(x), rows)
                if self.layer_scale:
                    y = self._block("ls1", d)(y)
                x = drop_path(y) + x
                if fuse:
                    y = self._fused_mlp(x, d, rows)
                else:
                    y = self._block("mlp", d)(self._block("norm2", d)(x), rows)
                if self.layer_scale:
                    y = self._block("ls2", d)(y)
                x = drop_path(y) + x
        return x


@contextlib.contextmanager
def _replay(generators, states, stats):
    """Run the body with each generator at its saved state, then put each
    back where it was, so that a recompute draws the forward's masks and
    leaves the stream of later draws alone; and put back the BatchNorm
    statistics ``stats``, which the forward has already moved (flax's
    ``nn.remat`` keeps the forward's update alone)."""
    now = [g.get_state() for g in generators]
    kept = [t.clone() for t in stats]
    for g, st in zip(generators, states):
        g.set_state(st)
    try:
        yield
    finally:
        for g, st in zip(generators, now):
            g.set_state(st)
        with torch.no_grad():
            for t, k in zip(stats, kept):
                t.copy_(k)


def checkpointed(stage: nn.Module, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
    """``stage(x, rows)`` whose activations are recomputed in the backward.

    The recompute sees what the forward saw. Its parameters and buffers
    are the tensors the stage holds at the forward (under the train
    step's ``functional_call`` these are the bf16 casts, gone by the time
    of the backward), passed in as arguments. A stage that FSDP2 shards
    (``parallel/mesh.py:shard_model``) holds its shards outside its
    forward, so its recompute calls the stage as it is: FSDP2's
    pre-backward hook, which fires on the stage's output before the
    recompute, has gathered the parameters again, and its forward hooks
    leave a call made in the backward alone. Drop path and dropout draw
    from a generator the caller owns, which ``torch.utils.checkpoint``
    does not restore (it restores the global RNG only): its state at the
    forward is replayed for the recompute. The BatchNorms' running
    statistics (the stage's CMT MLPs) move in the forward only. On a row
    shard the recompute exchanges rows again, in the forward's order on
    every spatial peer (``parallel/spatial.py``).
    """
    tensors = dict(stage.named_parameters())
    tensors.update(stage.named_buffers())
    generators = list({id(m.generator): m.generator for m in stage.modules()
                       if isinstance(m, Dropout) and m.generator is not None}.values())
    states = [g.get_state() for g in generators]
    stats = [tensors[f"{name}.{b}"] for name, m in stage.named_modules()
             if isinstance(m, nn.BatchNorm2d) for b, _ in m.named_buffers(recurse=False)]
    if is_sharded(stage):
        def run(inp, _):
            return stage(inp, rows)
    else:
        def run(inp, t):
            return torch.func.functional_call(stage, t, (inp, rows))
    return checkpoint(
        run, x, tensors, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _replay(generators, states, stats)),
    )


class DAT(nn.Module):
    """DAT backbone returning one NHWC feature map per ``out_indices``."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 4,
        expansion: int = 4,
        dim_stem: int = 96,
        dims: Sequence[int] = (96, 192, 384, 768),
        depths: Sequence[int] = (2, 2, 6, 2),
        heads: Sequence[int] = (3, 6, 12, 24),
        window_sizes: Sequence[int] = (7, 7, 7, 7),
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        strides: Sequence[int] = (-1, -1, -1, -1),
        offset_range_factor: Sequence[float] = (1, 2, 3, 4),
        stage_spec: Sequence[Sequence[str]] = (
            ("L", "D"), ("L", "D"), ("L", "D", "L", "D", "L", "D"), ("L", "D"),
        ),
        groups: Sequence[int] = (-1, -1, 3, 6),
        use_pes: Sequence[bool] = (False,) * 4,
        dwc_pes: Sequence[bool] = (False,) * 4,
        fixed_pes: Sequence[bool] = (False,) * 4,
        no_offs: Sequence[bool] = (False,) * 4,
        use_dwc_mlps: Sequence[bool] = (False,) * 4,
        use_conv_patches: bool = False,
        ksizes: Sequence[int] = (9, 7, 5, 3),
        layer_scale_values: Sequence[float] = (-1, -1, -1, -1),
        use_lpus: Sequence[bool] = (False,) * 4,
        use_cmt_mlps: Sequence[bool] = (False,) * 4,
        log_cpb: Sequence[bool] = (False,) * 4,
        out_indices: Sequence[int] = (0, 1, 2, 3),
        kernel_impl: str = "xla",
        use_checkpoint: bool = False,
    ):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.use_checkpoint = use_checkpoint
        self.use_conv_patches = use_conv_patches
        self.patch_size = patch_size
        if use_conv_patches:
            self.stem_conv1 = Conv2d(3, dim_stem // 2, 3, stride=patch_size // 2, padding=1)
            self.stem_ln1 = LayerNorm2d(dim_stem // 2)
            self.stem_conv2 = Conv2d(dim_stem // 2, dim_stem, 3, stride=patch_size // 2, padding=1)
            self.stem_ln2 = LayerNorm2d(dim_stem)
        else:
            self.stem_conv1 = Conv2d(3, dim_stem, patch_size, stride=patch_size)
            self.stem_ln1 = LayerNorm2d(dim_stem)

        # linear drop-path schedule over all blocks (reference dat.py:225)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        fmap = img_size // patch_size
        in_dim = dim_stem
        for i in range(4):
            self.add_module(
                f"stage_{i}",
                TransformerStage(
                    in_dim=in_dim,
                    fmap_size=(fmap, fmap),
                    window_size=window_sizes[i],
                    dim_embed=dims[i],
                    depths=depths[i],
                    stage_spec=stage_spec[i],
                    n_groups=groups[i],
                    use_pe=use_pes[i],
                    heads=heads[i],
                    stride=strides[i],
                    offset_range_factor=offset_range_factor[i],
                    dwc_pe=dwc_pes[i],
                    no_off=no_offs[i],
                    fixed_pe=fixed_pes[i],
                    attn_drop=attn_drop_rate,
                    proj_drop=drop_rate,
                    expansion=expansion,
                    drop=drop_rate,
                    drop_path_rates=dpr[sum(depths[:i]) : sum(depths[: i + 1])],
                    use_dwc_mlp=use_dwc_mlps[i],
                    ksize=ksizes[i],
                    layer_scale_value=layer_scale_values[i],
                    use_lpu=use_lpus[i],
                    use_cmt_mlp=use_cmt_mlps[i],
                    log_cpb=log_cpb[i],
                    kernel_impl=kernel_impl,
                ),
            )
            if i in self.out_indices:
                self.add_module(f"out_norm_{i}", LayerNorm2d(dims[i]))
            if i < 3:
                if use_conv_patches:
                    down = Conv2d(dims[i], dims[i + 1], 3, stride=2, padding=1, bias=False)
                else:
                    down = Conv2d(dims[i], dims[i + 1], 2, stride=2, bias=False)
                self.add_module(f"down_conv_{i}", down)
                self.add_module(f"down_ln_{i}", LayerNorm2d(dims[i + 1]))
            fmap //= 2
            in_dim = dims[i + 1] if i < 3 else dims[i]

    def forward(self, x: torch.Tensor, rows: Optional[Rows] = None
                ) -> Union[List[torch.Tensor], Tuple[List[torch.Tensor], List[Rows]]]:
        """The outputs; on a row shard of the image (``rows``) their row
        shards and their layouts."""
        r = rows
        x = self.stem_ln1(self.stem_conv1(x, r))
        r = self.stem_conv1.out_rows(r)
        if self.use_conv_patches:
            x = self.stem_ln2(self.stem_conv2(gelu(x), r))
            r = self.stem_conv2.out_rows(r)
        outs, out_rows = [], []
        remat = self.use_checkpoint and self.training and torch.is_grad_enabled()
        for i in range(4):
            stage = getattr(self, f"stage_{i}")
            x = checkpointed(stage, x, r) if remat else stage(x, r)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm_{i}")(x))
                out_rows.append(r)
            if i < 3:
                down = getattr(self, f"down_conv_{i}")
                x = getattr(self, f"down_ln_{i}")(down(x, r))
                r = down.out_rows(r)
        return outs if rows is None else (outs, out_rows)
