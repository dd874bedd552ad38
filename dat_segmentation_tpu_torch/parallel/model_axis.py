"""Tensor parallelism over the mesh's ``model`` axis (``fsdp='model'``).

Counterpart of the JAX package's ``fsdp='model'`` on a ``{"data": X,
"model": Y}`` mesh (``parallel/mesh.py:fsdp_sharding`` and
``parallel/train_step.py`` there), where GSPMD partitions each matmul over
the weight shards. Here the shards are plain parameters holding this
rank's slice, and the split modules call the autograd collectives of
``parallel/mesh.py`` in Megatron's column- and row-parallel pattern:

* every block's MLP (``Mlp``, ``ConvMlp``, ``CmtConvMlp``): ``fc1`` split by
  output (column), the depthwise ``dwc`` and the CMT BatchNorms ``bn1``/
  ``bn2`` by channel, ``fc2`` by input (row), its partial sums all-reduced
  and its bias added once;
* each ``DeformableAttention`` whose offset groups divide by Y, in every
  position-bias mode: ``proj_q`` column by group (channels are
  group-major), the offsets and the sampling on this rank's groups, the
  sampled features all-gathered before the column ``proj_k``/``proj_v``
  (whose backward sums them over the peers; ``no_off``'s pooled features
  are every channel already), then K1 or the composite on this rank's
  heads: ``rpe_table`` split by head (the continuous bias's and
  ``fixed_pe``'s), ``dwc_pe``'s depthwise ``rpe_dwc`` by channel,
  attention dropout on this rank's heads' slice of the whole mask;
  ``proj_out`` row. The offset net and ``log_cpb``'s ``cpb_fc1``/``cpb_fc2``
  are shared by all groups, so their gradient is summed over the peers
  (``partial``);
* the heads' convolutions (``ConvBNReLU``, ``FPNNeck``'s laterals and
  output convs) and ``ClsHead.fc`` split by output, their outputs
  all-gathered for the replicated compute after them (whose backward takes
  this rank's slice);
* every other parameter the JAX rule shards (``jax_layout_dim``: 2^14
  elements or more, a dim that divides by Y; the stem, the downsampling
  convs, ``cls_seg``, the X blocks' ``conv_attn`` at the B++ widths, the
  tables and projections of attention whose groups do not divide by Y)
  held as this rank's slice and gathered at each use for replicated
  compute (``models/layers.py:gather_at_use``), whose backward takes this
  rank's slice of the gradient every peer computed alike;
* the rest (LayerNorms, layer scales, biases, the LPUs: each below the JAX
  rule's minimum) whole on every model peer.

``model_axis_plan`` is the rule, a pure function of the modules and their
shapes; ``shard_model_axis`` applies it in place to a whole model (after
``broadcast_module``). ``parallel/mesh.py:full_state`` and
``load_full_state`` gather and slice by it, so checkpoints keep the
one-process format. K3 (``kernel_impl='pallas'``) runs on the MLP weights
gathered over the axis (``models/dat.py``), as GSPMD treats a kernel it
cannot partition. Beside a spatial axis every split module runs on row
shards (``parallel/spatial.py``): the MLPs' and heads' convs fetch their
halos on this rank's channels, the split attention runs on the whole maps
of the rank's B/S batch rows (``models/dat.py:TransformerStage._attend``),
K3 on halo slabs with the gathered weights, and a conv held as a slice
gathers its weight before it fetches its halo.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from ..models.deformable_attention import DeformableAttention
from ..models.heads import ClsHead, ConvBNReLU, FPNNeck
from ..models.layers import (BatchNorm2d, CmtConvMlp, ConvMlp, LayerNorm2d, LayerScale, Mlp,
                             gather_at_use)
from .mesh import ModelAxis, slice_of

_BN = ("weight", "bias", "running_mean", "running_var")
JAX_MIN_SIZE = 2 ** 14  # the JAX fsdp_sharding's min_size
HELD = "held as a slice, gathered at use (the JAX layout)"


class PlanEntry(NamedTuple):
    """One parameter's or buffer's place on the model axis: the dim it is
    split along (None: whole on every model peer), why, whether split
    compute uses it (its gradient is then a part on each peer, summed over
    the model group), and whether the rank holds a slice that is gathered
    at each use (``gathered``: the JAX layout of a leaf no split rule
    covers)."""

    dim: Optional[int]
    reason: str
    partial: bool = False
    gathered: bool = False


def jax_layout_dim(shape: Sequence[int], size: int) -> Optional[int]:
    """The dim the JAX package's ``fsdp_sharding`` shards a leaf of
    ``shape`` along over an axis of ``size``: its largest dim that divides
    by ``size`` (the last of equal ones) where the leaf has
    ``JAX_MIN_SIZE`` elements or more; None where the rule keeps it
    whole."""
    if size <= 1 or int(torch.Size(shape).numel()) < JAX_MIN_SIZE:
        return None
    cands = [(d, i) for i, d in enumerate(shape) if d % size == 0]
    return max(cands)[1] if cands else None


def _mlp_rule(mod, size):
    hidden = mod.fc1.out_features
    if hidden % size:
        return {}, (), f"MLP hidden width {hidden} does not divide by {size}: whole"
    dims = {"fc1.weight": 0, "fc1.bias": 0, "fc2.weight": 1}
    if hasattr(mod, "dwc"):
        dims.update({"dwc.weight": 0, "dwc.bias": 0})
    for bn in ("bn1", "bn2"):
        if hasattr(mod, bn):
            dims.update({f"{bn}.{b}": 0 for b in _BN})
    return dims, (), "MLP: fc1 column, fc2 row"


def _attn_rule(mod, size):
    if mod.n_groups % size:
        return {}, (), f"{mod.n_groups} offset groups do not divide by {size}: whole"
    dims = {f"{p}.{w}": 0 for p in ("proj_q", "proj_k", "proj_v", "rpe_dwc")
            for w in ("weight", "bias")}
    dims.update({"proj_out.weight": 1, "rpe_table": 0})
    partial = ("offset_dwc.weight", "offset_dwc.bias", "offset_ln.weight", "offset_ln.bias",
               "offset_proj.weight", "cpb_fc1.weight", "cpb_fc1.bias", "cpb_fc2.weight")
    return dims, partial, "attention split by offset group"


def _conv_rule(mod, size):
    out = mod.conv.out_channels
    if out % size:
        return {}, (), f"{out} output channels do not divide by {size}: whole"
    return dict({"conv.weight": 0}, **{f"bn.{b}": 0 for b in _BN}), (), "conv column, gathered"


def _neck_rule(mod, size):
    out = mod.lateral_0.out_features
    if out % size:
        return {}, (), f"{out} output channels do not divide by {size}: whole"
    return ({f"{k}_{i}.{w}": 0 for i in range(mod.n) for k in ("lateral", "fpn")
             for w in ("weight", "bias")}, (), "FPN neck convs column, gathered")


def _cls_rule(mod, size):
    out = mod.fc.out_features
    if out % size:
        return {}, (), f"{out} classes do not divide by {size}: whole"
    return {"fc.weight": 0, "fc.bias": 0}, (), "fc column, gathered"


_RULES = ((Mlp, _mlp_rule), (ConvMlp, _mlp_rule), (CmtConvMlp, _mlp_rule),
          (DeformableAttention, _attn_rule), (ConvBNReLU, _conv_rule), (FPNNeck, _neck_rule),
          (ClsHead, _cls_rule))

# what the leaves that stay whole are
_WHOLE = (("stem_", "the stem"), ("down_", "a downsampling conv or its LayerNorm"),
          ("conv_attn_", "an X block's depthwise window conv"), ("lpu_", "a local perception unit"),
          ("cls_seg", "the classifier"), ("proj", "a stage's input projection"))


def _rules(model: nn.Module, size: int):
    out = {}
    for prefix, mod in model.named_modules():
        for cls, rule in _RULES:
            if type(mod) is cls:
                out[prefix] = (mod,) + rule(mod, size)
    return out


def _what(model: nn.Module, name: str) -> str:
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    if isinstance(mod, LayerNorm2d):
        return "a LayerNorm of a whole activation"
    if isinstance(mod, LayerScale):
        return "a layer scale of a whole activation"
    if isinstance(mod, BatchNorm2d):
        return "a BatchNorm of a whole activation"
    last = owner.rpartition(".")[2]
    for start, what in _WHOLE:
        if last == start or (start.endswith("_") and last.startswith(start)):
            return what
    return f"{type(mod).__name__}.{leaf}"


def model_axis_plan(model: nn.Module, size: int) -> Dict[str, PlanEntry]:
    """For every parameter and buffer of a whole ``model`` (state_dict
    order), its ``PlanEntry`` on a model axis of ``size``: the split rules'
    dims, then ``jax_layout_dim`` for every parameter they leave whole
    (held as a slice, gathered at use). Pure: reads the modules and their
    shapes, issues no collective."""
    rules = _rules(model, size)
    params = {id(p) for p in model.parameters()}
    plan = {}
    for name, t in model.state_dict(keep_vars=True).items():
        owner = max((p for p in rules if p and name.startswith(p + ".")), key=len, default=None)
        _, dims, partial, why = rules[owner] if owner is not None else (None, {}, (), None)
        local = name[len(owner) + 1:] if owner is not None else name
        if local in dims:
            plan[name] = PlanEntry(dims[local], why)
            continue
        part = local in partial
        held = jax_layout_dim(t.shape, size) if id(t) in params else None
        if held is not None:
            plan[name] = PlanEntry(held, HELD, part, True)
        elif part:
            plan[name] = PlanEntry(None, "shared by the split groups: gradient summed over "
                                         "the model peers", True)
        elif local.endswith("num_batches_tracked"):
            plan[name] = PlanEntry(None, "a count")
        elif dims and local in ("fc2.bias", "proj_out.bias"):
            plan[name] = PlanEntry(None, "a row-parallel bias, added once after the sum")
        else:
            small = t.numel() < JAX_MIN_SIZE
            plan[name] = PlanEntry(None, f"{_what(model, name)}: whole, " + (
                f"below the JAX rule's {JAX_MIN_SIZE} elements" if small else
                f"no dim divides by {size}") + ("" if why is None else f" ({why})"))
    return plan


def _local_attrs(mod: nn.Module) -> None:
    """Module attributes that follow the sliced weights (a depthwise conv's
    ``groups`` above all)."""
    for sub in mod.modules():
        if isinstance(sub, nn.Conv2d):
            if sub.groups > 1:
                sub.groups = sub.in_channels = sub.weight.shape[0]
            sub.out_channels = sub.weight.shape[0]
        elif isinstance(sub, nn.Linear):
            sub.out_features, sub.in_features = sub.weight.shape
        elif isinstance(sub, nn.BatchNorm2d):
            sub.num_features = sub.weight.shape[0]


def shard_model_axis(model: nn.Module, axis: ModelAxis) -> nn.Module:
    """Split a whole ``model`` over ``axis`` in place by ``model_axis_plan``
    (every model peer holds the same whole model first): each split leaf
    keeps this rank's slice, each split module holds ``axis``, each module
    owning a leaf held as a slice gathers it at use
    (``models/layers.py:gather_at_use``; its attributes stay the whole
    module's), and the model holds ``axis``, ``model_axis_dims`` (name ->
    dim) and ``model_axis_partial`` (the whole leaves whose gradient is
    summed over the model group). Before the optimizer sees the
    parameters."""
    plan = model_axis_plan(model, axis.size)
    tensors = model.state_dict(keep_vars=True)

    def cut(held):
        with torch.no_grad():
            for name, entry in plan.items():
                if entry.dim is not None and entry.gathered == held:
                    t = tensors[name]
                    t.data = slice_of(t.data, entry.dim, axis).clone()

    cut(False)
    for prefix, (mod, dims, _, _) in _rules(model, axis.size).items():
        if dims:
            mod.model_axis = axis
            _local_attrs(mod)
    cut(True)  # after _local_attrs: a module gathering its leaf keeps its whole attributes
    owners: Dict[str, Dict[str, tuple]] = {}
    for name, entry in plan.items():
        if entry.gathered:
            owner, _, leaf = name.rpartition(".")
            owners.setdefault(owner, {})[leaf] = (axis, entry.dim, entry.partial)
    for owner, leaves in owners.items():
        gather_at_use(model.get_submodule(owner), leaves)
    model.model_axis = axis
    model.model_axis_dims = {n: e.dim for n, e in plan.items() if e.dim is not None}
    model.model_axis_partial = {n for n, e in plan.items() if e.partial and e.dim is None}
    return model
