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
* each ``DeformableAttention`` that runs K1 (``splits_by_group``) whose
  groups divide by Y: ``proj_q`` column by group (channels are
  group-major), the offsets, the sampling and K1 on this rank's groups
  (``rpe_table`` split by group), the sampled features all-gathered
  before the column ``proj_k``/``proj_v`` (whose backward sums them over
  the peers), ``proj_out`` row; the offset net is shared by all groups, so
  its gradient is summed over the peers (``partial``);
* the heads' convolutions (``ConvBNReLU``, ``FPNNeck``'s laterals and
  output convs) and ``ClsHead.fc`` split by output, their outputs
  all-gathered for the replicated compute after them (whose backward takes
  this rank's slice);
* everything else whole on every model peer.

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
and K3 on halo slabs with the gathered weights.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from ..models.deformable_attention import DeformableAttention
from ..models.heads import ClsHead, ConvBNReLU, FPNNeck
from ..models.layers import BatchNorm2d, CmtConvMlp, ConvMlp, LayerNorm2d, LayerScale, Mlp
from .mesh import ModelAxis, slice_of

_BN = ("weight", "bias", "running_mean", "running_var")


class PlanEntry(NamedTuple):
    """One parameter's or buffer's place on the model axis: the dim it is
    split along (None: whole on every model peer), why, and for a whole
    leaf whether split compute uses it (its gradient is then a part on each
    peer, summed over the model group)."""

    dim: Optional[int]
    reason: str
    partial: bool = False


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
    if not mod.splits_by_group():
        return {}, (), ("a position-bias mode K1 does not take (the composite): whole "
                        "(ROADMAP.md, Queue 1 item 13)")
    if mod.n_groups % size:
        return {}, (), f"{mod.n_groups} offset groups do not divide by {size}: whole"
    dims = {f"{p}.{w}": 0 for p in ("proj_q", "proj_k", "proj_v") for w in ("weight", "bias")}
    dims.update({"proj_out.weight": 1, "rpe_table": 0})
    partial = ("offset_dwc.weight", "offset_dwc.bias", "offset_ln.weight", "offset_ln.bias",
               "offset_proj.weight")
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

# why the leaves no rule covers stay whole
_WHOLE = (("stem_", "the stem"), ("down_", "a downsampling conv and its LayerNorm"),
          ("conv_attn_", "an X block's depthwise window conv"), ("lpu_", "a local perception unit"),
          ("cls_seg", "the classifier (channels x classes), read by every peer"),
          ("proj", "a stage's input projection"))


def _rules(model: nn.Module, size: int):
    out = {}
    for prefix, mod in model.named_modules():
        for cls, rule in _RULES:
            if type(mod) is cls:
                out[prefix] = (mod,) + rule(mod, size)
    return out


def _whole_reason(model: nn.Module, name: str) -> str:
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    if isinstance(mod, LayerNorm2d):
        return "a LayerNorm of a whole activation"
    if isinstance(mod, LayerScale):
        return "a layer scale of a whole activation"
    if isinstance(mod, BatchNorm2d):
        return "a BatchNorm of a whole activation"
    last = owner.rpartition(".")[2]
    for start, why in _WHOLE:
        if last.startswith(start):
            return why
    return f"{type(mod).__name__}.{leaf}: whole"


def model_axis_plan(model: nn.Module, size: int) -> Dict[str, PlanEntry]:
    """For every parameter and buffer of a whole ``model`` (state_dict
    order), its ``PlanEntry`` on a model axis of ``size``. Pure: reads the
    modules and their shapes, issues no collective."""
    rules = _rules(model, size)
    plan = {}
    for name, t in model.state_dict(keep_vars=True).items():
        owner = max((p for p in rules if p and name.startswith(p + ".")), key=len, default=None)
        if owner is None:
            plan[name] = PlanEntry(None, _whole_reason(model, name))
            continue
        _, dims, partial, why = rules[owner]
        local = name[len(owner) + 1:]
        if local in dims:
            plan[name] = PlanEntry(dims[local], why)
        elif local in partial:
            plan[name] = PlanEntry(None, "shared by the split groups: gradient summed over "
                                         "the model peers", True)
        elif dims:
            if local.endswith("num_batches_tracked"):
                plan[name] = PlanEntry(None, "a count")
            elif local.endswith(".bias"):
                plan[name] = PlanEntry(None, "a row-parallel bias, added once after the sum")
            else:
                plan[name] = PlanEntry(None, _whole_reason(model, name))
        else:
            plan[name] = PlanEntry(None, why)
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
    keeps this rank's slice, each split module holds ``axis``, and the
    model holds ``axis``, ``model_axis_dims`` (name -> dim) and
    ``model_axis_partial`` (the whole leaves whose gradient is summed over
    the model group). Before the optimizer sees the parameters."""
    plan = model_axis_plan(model, axis.size)
    tensors = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, entry in plan.items():
            if entry.dim is not None:
                t = tensors[name]
                t.data = slice_of(t.data, entry.dim, axis).clone()
    for prefix, (mod, dims, _, _) in _rules(model, axis.size).items():
        if dims:
            mod.model_axis = axis
            _local_attrs(mod)
    model.model_axis = axis
    model.model_axis_dims = {n: e.dim for n, e in plan.items() if e.dim is not None}
    model.model_axis_partial = {n for n, e in plan.items() if e.partial}
    return model
