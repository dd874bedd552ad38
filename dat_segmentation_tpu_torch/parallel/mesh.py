"""Processes, the mesh's axes and the collectives of the port's scale-out.

Counterpart of ``dat_segmentation_tpu/parallel/mesh.py``. There GSPMD
compiles one program over the global batch on a ``jax.sharding.Mesh``; here
each process of ``torch.distributed`` runs the step on its share of the
global batch, and the places where the JAX program reads the whole batch
reduce across processes explicitly.

The mesh is a dict of the axes ``data``, ``model`` and ``spatial`` over
their product of processes (``-1``: all the processes the other axes
leave), laid out as the JAX package's ``make_mesh`` reshapes its devices:
in the dict's order (``data`` first where the dict leaves it out), so on
``{"data": X, "model": Y, "spatial": S}`` rank ``(d·Y + m)·S + s`` is data
coordinate d, model coordinate m, spatial coordinate s, and on ``{"data":
X, "spatial": S, "model": Y}`` rank ``(d·S + s)·Y + m``; the last axis's
peers are adjacent ranks (one node). ``rank_grid`` gives that placement,
``resolve_mesh`` makes the ``Layout``: a process group for each line of the
mesh, the data groups (the X ranks of one (m, s)), the model groups (the Y
ranks of one (d, s)), the spatial groups (the S ranks of one (d, m)) and,
with both a model and a spatial axis, the rows groups (the X·S ranks of
one model coordinate); every rank creates every group, in one order. The
batch is sharded over ``data``: the model and spatial peers of a data
coordinate load the same rows (``process_shard_info`` gives the data
coordinate); the spatial peers then split each image's rows
(``parallel/spatial.py``).

* Every reduction over the global batch goes over this rank's data group:
  BatchNorm's statistics of a replicated tensor (``models/layers.py:
  BatchNorm2d``), dropout and drop path's masks (``models/layers.py:
  Dropout``), mixup's pairs (``mirror_rows``), the classifier's metrics,
  the eval's counts (``all_reduce_host(..., data_axis=True)``). Over the
  world, each row would count Y·S times. A reduction over row-sharded
  activations (``rows``: BatchNorm on a row shard, the losses' pixel
  counts, the gradient sum, the IoU counts) goes over the data × spatial
  group of this rank's model coordinate, ``Layout.rows_group``; over the
  world it would count each pixel Y times.
* ``fsdp=True`` (or ``'data'``) shards the parameters and AdamW's moments
  over the data groups (ZeRO) with FSDP2 (``shard_model``); model peers
  compute the same thing, spatial peers sum their sharded gradients.
* ``fsdp='spatial'`` shards them over the spatial groups and replicates
  them over the data groups (FSDP2 on the 2-D (data, spatial) mesh of the
  model coordinate: HSDP); the reduce-scatter sums the spatial peers'
  parts, the all-reduce the data replicas'. A rank holds 1/S of each
  parameter's and moment's rows.
* ``fsdp='model'`` is tensor parallelism over the model groups
  (``parallel/model_axis.py``): parameters held as this rank's slices,
  Megatron's column- and row-parallel layers through the autograd
  collectives below (``copy_to_model``, ``reduce_from_model``,
  ``gather_model``), ``full_state`` and ``load_full_state`` gathering and
  slicing them in the one-process format. Beside a spatial axis the split
  modules run on row shards: each model group holds one spatial
  coordinate's rows, so its collectives' shapes agree.

With no process group initialised nothing here issues a collective, and
every caller runs its one-process code.

Collectives on the step's tensors go over NCCL on the card, gloo on the
CPU. Host-side control values (the preemption flag, the eval's int64
counts) go over gloo groups (``control_group`` for the world, the layout's
``data_control`` for a data group) even under NCCL, so reading them does
not wait on the CUDA stream.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..utils.device import resolve_device

BUCKET_BYTES = 64 << 20  # the gradient all-reduce's bucket
_AXES = ("data", "model", "spatial")
_DATA = object()  # reduce_gradients' default group: this rank's data group
_control: Dict[str, object] = {}  # the gloo group beside an NCCL default group
_layouts: Dict[Tuple[int, int, int], "Layout"] = {}  # by (data, model, spatial), made once
_current: Dict[str, "Layout"] = {}  # the layout the last resolve_mesh chose


def is_distributed() -> bool:
    """True inside an initialised ``torch.distributed`` process group."""
    return dist.is_available() and dist.is_initialized()


def is_main() -> bool:
    """True for the process that logs and writes: rank 0 of the group (the
    only process without one)."""
    return not is_distributed() or dist.get_rank() == 0


@dataclass(frozen=True)
class ModelAxis:
    """This process's place on the model (or spatial) axis: its
    coordinate, the axis's size and the process group of its peers. A
    model split by ``parallel/model_axis.py:shard_model_axis`` holds it on
    every split module; a row shard's ``parallel/spatial.py:Rows`` holds
    the spatial axis's."""

    rank: int
    size: int
    group: object


@dataclass(frozen=True)
class Layout:
    """The process mesh ``{data: X, model: Y, spatial: S}``: this rank's
    coordinates and groups. ``rows_group`` is data × spatial at this rank's
    model coordinate (the data group when S = 1). A group None is the
    default group (``data_group`` when Y = S = 1, ``rows_group`` when Y =
    1); ``data_control`` None is ``control_group()``."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object = None
    model_group: object = None
    data_control: object = None
    spatial: int = 1
    spatial_rank: int = 0
    spatial_group: object = None
    rows_group: object = None
    rows_ranks: Tuple[Tuple[int, ...], ...] = ()  # the (X, S) ranks of this model coordinate

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """The model axis when it is larger than 1."""
        if self.model == 1:
            return None
        return ModelAxis(self.model_rank, self.model, self.model_group)

    @property
    def spatial_axis(self) -> Optional[ModelAxis]:
        """The spatial axis when it is larger than 1."""
        if self.spatial == 1:
            return None
        return ModelAxis(self.spatial_rank, self.spatial, self.spatial_group)


def layout() -> Layout:
    """The layout ``resolve_mesh`` chose last; before it (or without a
    process group) the data axis over every process."""
    if "layout" in _current:
        return _current["layout"]
    if not is_distributed():
        return Layout(1, 1, 0, 0)
    return Layout(dist.get_world_size(), 1, dist.get_rank(), 0)


def process_shard_info() -> Tuple[int, int]:
    """(data coordinate, data axis size) for ``DataLoader(shard_info=...)``:
    each data coordinate loads a disjoint 1/X slice of every global batch,
    the model peers of one coordinate the same slice; (0, 1) alone."""
    lay = layout()
    return lay.data_rank, lay.data


def local_batch_size(global_batch_size: int) -> int:
    """Per-process batch size given the configured GLOBAL batch size."""
    world = process_shard_info()[1]
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} is not a multiple of the "
                         f"{world} data-parallel processes")
    return global_batch_size // world


def init_distributed(backend: Optional[str] = None, *, init_method: str = "env://",
                     device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` with ``env://``) and
    return this process's device: ``cuda:LOCAL_RANK`` (made current before
    NCCL starts) unless ``device`` names another. ``backend`` defaults to
    NCCL on the card and gloo on the CPU; gloo on the card is for more than
    one process on one card, which NCCL refuses."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    _layouts.clear()  # a layout resolved before the group is not this group's
    _current.clear()
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    control_group()  # a collective: every rank creates it here, together
    return dev


def destroy_distributed() -> None:
    """Leave the process group (and its gloo control and mesh groups)."""
    _control.clear()
    _layouts.clear()
    _current.clear()
    if is_distributed():
        dist.destroy_process_group()


def control_group():
    """The gloo group for host-side values: the default group when it is
    gloo, else a gloo group over the same ranks (made at first use, which
    ``init_distributed`` makes on every rank)."""
    if dist.get_backend() == "gloo":
        return None
    if "group" not in _control:
        _control["group"] = dist.new_group(backend="gloo")
    return _control["group"]


def _axis_sizes(shape: Dict[str, int], world: int) -> Dict[str, int]:
    """The JAX ``make_mesh`` rule: -1 takes what the other axes leave."""
    known = int(np.prod([v for v in shape.values() if v > 0])) or 1
    return {k: (world // known if v == -1 else v) for k, v in shape.items()}


def _check_fsdp_axis(sizes: Dict[str, int], axis: str) -> None:
    """The JAX package's refusal (``mesh.py:_check_fsdp_axis`` there): fsdp
    over a missing or size-1 axis would silently replicate."""
    if axis not in sizes:
        raise ValueError(f"fsdp axis {axis!r} is not a mesh axis (mesh has {tuple(sizes)}); "
                         "refusing to silently replicate")
    if sizes[axis] <= 1:
        raise ValueError(f"fsdp axis {axis!r} has size {sizes[axis]}; sharding over it is a "
                         "no-op — drop fsdp or grow the axis")


def mesh_sizes(mesh_shape: Optional[Dict[str, int]], world: int) -> Dict[str, int]:
    """The axes' sizes of ``mesh_shape`` (default ``{"data": -1}``) over
    ``world`` processes, in the mesh's order (``data`` first where the dict
    leaves it out; ``model`` and ``spatial`` of 1 where it does): the data,
    model and spatial axes, another name only at size 1
    (``NotImplementedError``), their product ``world`` (``ValueError``)."""
    shape = dict(mesh_shape or {"data": -1})
    for axis, size in shape.items():
        if axis not in _AXES and size != 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {size}: the port's axes are {', '.join(_AXES)}")
    shape = {k: v for k, v in shape.items() if k in _AXES}
    sizes = _axis_sizes(shape, world)
    if "data" not in sizes:
        rest = int(np.prod(list(sizes.values()))) or 1
        sizes = dict(data=world // rest, **sizes)
    for axis in _AXES:
        sizes.setdefault(axis, 1)
    if int(np.prod(list(sizes.values()))) != world or min(sizes.values()) < 1:
        raise ValueError(f"mesh {shape} ({' x '.join(map(str, sizes.values()))}) in a group of "
                         f"{world} processes")
    return sizes


def rank_grid(sizes: Dict[str, int]) -> np.ndarray:
    """The ranks on the mesh ``sizes`` (``mesh_sizes``' order) as the JAX
    ``make_mesh`` reshapes its devices, indexed [data, model, spatial]:
    ``rank_grid(sizes)[d, m, s]`` is the rank at those coordinates."""
    names = list(sizes)
    grid = np.arange(int(np.prod(list(sizes.values())))).reshape([sizes[a] for a in names])
    return np.transpose(grid, [names.index(a) for a in _AXES])


def resolve_mesh(mesh_shape: Optional[Dict[str, int]] = None,
                 fsdp: Union[bool, str] = False) -> Layout:
    """The ``Layout`` of ``mesh_shape`` (default ``{"data": -1}``: every
    process) in this process group (one process without one), made the
    current one; its groups are made at the first call for a mesh (every
    rank calls this at the same points). The axes are ``data``, ``model``
    and ``spatial``, in any combination and order (``mesh_sizes``), their
    product the group's size. ``fsdp`` True or ``'data'`` shards over the
    data axis of a process group (of any size); ``fsdp='model'`` splits over
    the model axis and ``fsdp='spatial'`` shards over the spatial axis,
    which must exist with a size above 1 (``ValueError``, as the JAX
    package)."""
    world = dist.get_world_size() if is_distributed() else 1
    sizes = mesh_sizes(mesh_shape, world)
    axis = fsdp if isinstance(fsdp, str) else "data"
    if fsdp and axis != "data":
        _check_fsdp_axis({k: v for k, v in sizes.items() if k in (mesh_shape or {})}, axis)
    elif fsdp and not is_distributed():  # FSDP2 over a data group of one runs (the card's probe)
        raise ValueError("fsdp axis 'data' shards over the processes of a group: call "
                         "parallel.init_distributed() first")
    key = tuple(sizes.items())
    if key not in _layouts:
        _layouts[key] = _make_layout(sizes)
    _current["layout"] = _layouts[key]
    return _current["layout"]


def _make_layout(sizes: Dict[str, int]) -> Layout:
    """This rank's ``Layout`` on the mesh ``sizes``, its groups made."""
    data, model, spatial = (sizes[a] for a in _AXES)
    if not is_distributed() or model * spatial == 1:
        return Layout(data, 1, dist.get_rank() if is_distributed() else 0, 0)
    grid = rank_grid(sizes)
    rank = dist.get_rank()
    d, m, s = (int(i) for i in np.argwhere(grid == rank)[0])
    host_groups = dist.get_backend() != "gloo"  # host values need gloo data groups too
    mine = {}

    def make(lines, key, twin=None):  # every rank creates every line's group, in order
        for ranks in lines:
            ranks = sorted(int(r) for r in np.ravel(ranks))
            g = dist.new_group(ranks)
            c = dist.new_group(ranks, backend="gloo") if twin and host_groups else g
            if rank in ranks:
                mine[key] = g
                if twin:
                    mine[twin] = c

    make([grid[:, j, k] for j in range(model) for k in range(spatial)], "data_group",
         "data_control")
    if model > 1:
        make([grid[i, :, k] for i in range(data) for k in range(spatial)], "model_group")
    if spatial > 1:
        make([grid[i, j, :] for i in range(data) for j in range(model)], "spatial_group")
    if model > 1 and spatial > 1:
        make([grid[:, j, :] for j in range(model)], "rows_group")
    elif model > 1:
        mine["rows_group"] = mine["data_group"]
    return Layout(data, model, d, m, spatial=spatial, spatial_rank=s,
                  rows_ranks=tuple(map(tuple, grid[:, m, :].tolist())), **mine)


# ---------------------------------------------------------------- collectives --


def all_reduce(t: torch.Tensor, *, rows: bool = False) -> torch.Tensor:
    """``t`` summed over this rank's data group, in place (not
    differentiable): the global batch's sum; with ``rows``, a sum over
    row-sharded activations, over the data × spatial group of this rank's
    model coordinate (``Layout.rows_group``)."""
    lay = layout()
    dist.all_reduce(t, group=lay.rows_group if rows else lay.data_group)
    return t


def all_reduce_host(values, op=dist.ReduceOp.SUM, *, data_axis: bool = False) -> np.ndarray:
    """A host array (int64 counts, flags) reduced over the gloo control
    group: over every process, or with ``data_axis`` over this rank's data
    group (counts of the global batch, which model and spatial peers hold
    alike)."""
    t = torch.from_numpy(np.array(values, dtype=np.int64, ndmin=1))
    lay = layout()
    group = control_group()
    if data_axis and lay.model * lay.spatial > 1:
        group = lay.data_control
    dist.all_reduce(t, op=op, group=group)
    return t.numpy()


def barrier() -> None:
    """Wait for every process, on the control group (no CUDA stream)."""
    dist.barrier(group=control_group())


def mirror_rows(t: torch.Tensor) -> torch.Tensor:
    """The rows that pair with this process's rows when the GLOBAL batch
    (the data coordinates' batches in order) is flipped: coordinate d's
    partners are coordinate X-1-d's rows, reversed. ``t.flip(0)`` alone."""
    if not is_distributed():
        return t.flip(0)
    rank, world = process_shard_info()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=layout().data_group)
    return parts[world - 1 - rank].flip(0)


def broadcast_module(model: nn.Module) -> None:
    """Every parameter and buffer of ``model`` set to rank 0's."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)


def reduce_gradients(grads: Sequence[torch.Tensor], group=_DATA, *,
                     src: Optional[int] = None) -> None:
    """Sum ``grads`` over this rank's data group (or ``group``, None the
    world), in place, in buckets of about ``BUCKET_BYTES`` (one collective
    a bucket); with ``src`` (a global rank in ``group``) set them to that
    rank's instead."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    group = layout().data_group if group is _DATA else group
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = _flatten_dense_tensors(bucket)
        if src is None:
            dist.all_reduce(flat, group=group)
        else:
            dist.broadcast(flat, src=src, group=group)
        for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(r)
        bucket.clear()

    for g in grads:
        bucket.append(g)
        size += g.numel() * g.element_size()
        if size >= BUCKET_BYTES:
            flush()
            size = 0
    if bucket:
        flush()


def gather_tensor(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """The whole tensor whose slices along ``dim`` the model peers hold, in
    their order (not differentiable)."""
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def slice_of(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """This rank's slice of a whole tensor along ``dim`` (equal slices in
    model coordinate order)."""
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * n, n)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model peers (a
    replicated tensor entering split compute: each peer's gradient is a
    part of the whole)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model peers (a row-parallel product's partial
    sums); the backward passes the (replicated) gradient on."""

    @staticmethod
    def forward(ctx, x, axis):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """The model peers' slices along ``dim`` joined. The backward takes this
    rank's slice of the gradient when what reads the whole is replicated
    (every peer holds the same gradient), or first sums it over the peers
    (a reduce-scatter) when split compute reads it (each peer holds a
    part)."""

    @staticmethod
    def forward(ctx, x, axis, dim, summed):
        ctx.axis, ctx.dim, ctx.summed = axis, dim, summed
        return gather_tensor(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.axis.group)
        return slice_of(g, ctx.dim, ctx.axis).contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` as it enters split compute (Megatron's f)."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` summed over the model peers (Megatron's g)."""
    return _ReduceFromModel.apply(x, axis)


def gather_model(x: torch.Tensor, axis: ModelAxis, dim: int = -1, *,
                 split_consumer: bool = False) -> torch.Tensor:
    """The model peers' slices of ``x`` along ``dim`` joined, with the
    backward ``split_consumer`` says (``_GatherModel``)."""
    return _GatherModel.apply(x, axis, dim % x.ndim, split_consumer)


# ----------------------------------------------------------------------- fsdp --


def shard_model(model: nn.Module, compute_dtype: torch.dtype, axis: str = "data") -> nn.Module:
    """ZeRO over the ``axis`` (FSDP2's ``fully_shard``, in place): over
    this rank's data group (``'data'``), or over its spatial group and
    replicated over its data group (``'spatial'``: HSDP on the 2-D (data,
    spatial) mesh of this model coordinate). A unit for each backbone
    stage, each head and the root, the parameters gathered in
    ``compute_dtype`` for the forward and the gradients reduce-scattered in
    float32 and summed (not averaged: the losses divide by global counts,
    and the spatial peers' gradients are parts). Buffers (BatchNorm
    statistics) stay whole on every process. With ``use_checkpoint`` a
    stage's recompute runs on the parameters FSDP2 gathers again before
    the stage's backward (``models/dat.py:checkpointed``). The model keeps
    ``axis`` as ``fsdp_axis``."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import FSDPModule, MixedPrecisionPolicy, fully_shard

    from ..models.dat import TransformerStage

    lay = layout()
    device = next(model.parameters()).device.type
    kw = {}
    if axis == "spatial":
        kw["mesh"] = DeviceMesh.from_group([lay.data_group, lay.spatial_group], device,
                                           mesh=lay.rows_ranks, mesh_dim_names=("data", "spatial"))
    elif lay.model * lay.spatial > 1:  # the data group of a larger mesh (the peers shard alike)
        kw["mesh"] = DeviceMesh.from_group(lay.data_group, device)
    policy = MixedPrecisionPolicy(param_dtype=compute_dtype, reduce_dtype=torch.float32)
    for m in model.modules():
        if isinstance(m, TransformerStage):
            fully_shard(m, mp_policy=policy, **kw)
    for name, child in model.named_children():
        if name != "backbone":
            fully_shard(child, mp_policy=policy, **kw)
    fully_shard(model, mp_policy=policy, **kw)
    for m in model.modules():
        if isinstance(m, FSDPModule):  # a plain SUM (gloo has no AVG or PREMUL_SUM)
            m.set_gradient_divide_factor(1.0)
            m.set_force_sum_reduction_for_comms(True)
    model.fsdp_axis = axis
    return model


def shard_group(model: nn.Module):
    """The group whose ranks hold the shards of a model FSDP2 shards: the
    data group, or the spatial group under ``fsdp='spatial'``."""
    lay = layout()
    return lay.spatial_group if getattr(model, "fsdp_axis", "data") == "spatial" else \
        lay.data_group


def is_sharded(model: nn.Module) -> bool:
    """True for a model FSDP2 shards (``shard_model``)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def model_axis_of(model: nn.Module) -> Optional[ModelAxis]:
    """The model axis a tensor-parallel model (``parallel/model_axis.py:
    shard_model_axis``) is split over; None for any other."""
    return getattr(model, "model_axis", None)


def is_split(model: nn.Module) -> bool:
    """True for a model FSDP2 shards or the model axis splits: its whole
    state is gathered (``full_state``)."""
    return is_sharded(model) or model_axis_of(model) is not None


def local(t: torch.Tensor) -> torch.Tensor:
    """This process's shard of a sharded (DTensor) parameter or gradient,
    or ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def sharded_norm(tensors: Sequence[torch.Tensor],
                 split: Optional[Sequence[bool]] = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``tensors`` (this
    process's shards) in float32: FSDP's shards summed over ``group`` (the
    shards' group, ``shard_group``); with ``split`` (a tensor-parallel
    model's leaves, True where split), the split leaves summed over the
    model group and the whole ones counted once."""
    sq = [torch.linalg.vector_norm(local(t).float()) ** 2 for t in tensors]
    if split is None:
        total = torch.stack(sq).sum()
        dist.all_reduce(total, group=group)
        return total.sqrt()
    zero = sq[0].new_zeros(())
    parts = torch.stack([sum((q for q, s in zip(sq, split) if s), zero),
                         sum((q for q, s in zip(sq, split) if not s), zero)])
    whole = parts[1].clone()
    dist.all_reduce(parts, group=layout().model_group)
    return (parts[0] + whole).sqrt()


def _param_names(model: nn.Module, optimizer) -> List[str]:
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_split(model, optimizer, optim_sd, fn):
    """``optim_sd`` (keyed by ``optimizer``'s parameter index) with each
    split parameter's moments passed through ``fn(tensor, dim)`` (the
    scalar ``step`` as it is)."""
    dims = model.model_axis_dims
    names = _param_names(model, optimizer)
    return {"state": {i: {k: (fn(v, dims[names[i]]) if names[i] in dims and torch.is_tensor(v)
                               and v.ndim else v) for k, v in s.items()}
                      for i, s in optim_sd["state"].items()},
            "param_groups": optim_sd["param_groups"]}


def full_state(model: nn.Module, optimizer=None, *, everywhere: bool = False):
    """(model state_dict, optimizer state_dict) in the one-process format
    (the optimizer's keyed by parameter index), gathered from the shards
    on every process: held on the CPU by rank 0 (the others get empty
    dicts), or with ``everywhere`` on every process's device. A replicated
    model gives its own. Every process calls this (a collective)."""
    axis = model_axis_of(model)
    if axis is not None:
        return _full_split_state(model, optimizer, axis, everywhere)
    if not is_sharded(model):
        return model.state_dict(), None if optimizer is None else optimizer.state_dict()
    from torch.distributed.checkpoint.state_dict import (StateDictOptions, get_model_state_dict,
                                                         get_optimizer_state_dict)

    opts = StateDictOptions(full_state_dict=True, cpu_offload=not everywhere)
    msd = get_model_state_dict(model, options=opts)
    if optimizer is None:
        return msd, None
    osd = get_optimizer_state_dict(model, optimizer, options=opts)
    if not osd:
        return msd, osd
    index = {n: i for i, n in enumerate(_param_names(model, optimizer))}
    return msd, {"state": {index[n]: s for n, s in osd["state"].items()},
                 "param_groups": [dict(g, params=[index[n] for n in g["params"]])
                                  for g in osd["param_groups"]]}


def _full_split_state(model, optimizer, axis: ModelAxis, everywhere: bool):
    dims = model.model_axis_dims
    keep = everywhere or dist.get_rank() == 0

    def whole(t, dim):
        t = gather_tensor(t.detach(), dim, axis) if dim is not None else t.detach()
        return t if everywhere else t.cpu()

    msd = {k: whole(v, dims.get(k)) for k, v in model.state_dict().items()}
    osd = None
    if optimizer is not None:
        osd = _map_split(model, optimizer, optimizer.state_dict(), whole)
    if not keep:
        return {}, None if optimizer is None else {}
    return msd, osd


def load_full_state(model: nn.Module, model_sd, optimizer=None, optim_sd=None) -> None:
    """Load one-process state dicts (every process passes the whole) into
    ``model`` and ``optimizer``, sharded, split or not."""
    axis = model_axis_of(model)
    if axis is not None:
        dims = model.model_axis_dims
        model.load_state_dict({k: slice_of(v, dims[k], axis) if k in dims else v
                               for k, v in model_sd.items()})
        if optimizer is not None:
            optimizer.load_state_dict(_map_split(model, optimizer, optim_sd, lambda t, d: slice_of(
                t, d, axis).clone()))
        return
    if not is_sharded(model):
        model.load_state_dict(model_sd)
        if optimizer is not None:
            optimizer.load_state_dict(optim_sd)
        return
    from torch.distributed.checkpoint.state_dict import (StateDictOptions, set_model_state_dict,
                                                         set_optimizer_state_dict)

    opts = StateDictOptions(full_state_dict=True)
    set_model_state_dict(model, model_sd, options=opts)
    if optimizer is not None:
        names = _param_names(model, optimizer)
        set_optimizer_state_dict(model, optimizer, {
            "state": {names[i]: s for i, s in optim_sd["state"].items()},
            "param_groups": [dict(g, params=[names[i] for i in g["params"]])
                             for g in optim_sd["param_groups"]]}, options=opts)
