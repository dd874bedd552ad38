"""Processes, the data axis and the collectives of the port's scale-out.

Counterpart of ``dat_segmentation_tpu/parallel/mesh.py``. There GSPMD
compiles one program over the global batch on a ``jax.sharding.Mesh``; here
each process of ``torch.distributed`` runs the step on its share of the
global batch, and the places where the JAX program reads the whole batch
reduce across processes explicitly:

* BatchNorm takes global statistics (``models/layers.py:BatchNorm2d``),
  dropout and drop path draw their masks over the global shape
  (``models/layers.py:Dropout``), mixup pairs sample i with sample B-1-i of
  the global batch (``data/mixup.py``), the losses divide by global counts
  (``train/losses.py``), and the step sums the gradients and returns global
  metrics (``train/train_step.py``).
* ``fsdp=True`` shards the parameters and AdamW's moments over the data
  axis (ZeRO) with FSDP2 (``shard_model``).

The data axis is the only one: ``resolve_mesh`` refuses a ``spatial`` or
``model`` axis and ``fsdp=<axis name>`` (ROADMAP.md, Queue 1 item 10).
With no process group initialised nothing here issues a collective, and
every caller runs its one-process code.

Collectives on the step's tensors go over the default group: NCCL on the
card, gloo on the CPU. Host-side control values (the preemption flag, the
eval's int64 counts) go over a gloo group (``control_group``) even under
NCCL, so reading them does not wait on the CUDA stream.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..utils.device import resolve_device

BUCKET_BYTES = 64 << 20  # the gradient all-reduce's bucket
_control: Dict[str, object] = {}  # the gloo group beside an NCCL default group


def is_distributed() -> bool:
    """True inside an initialised ``torch.distributed`` process group."""
    return dist.is_available() and dist.is_initialized()


def process_shard_info() -> Tuple[int, int]:
    """(rank, world) for ``DataLoader(shard_info=...)``: each process loads
    a disjoint 1/world slice of every global batch; (0, 1) alone."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_batch_size(global_batch_size: int) -> int:
    """Per-process batch size given the configured GLOBAL batch size."""
    world = process_shard_info()[1]
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} is not a multiple of the "
                         f"{world} processes")
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
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    control_group()  # a collective: every rank creates it here, together
    return dev


def destroy_distributed() -> None:
    """Leave the process group (and its gloo control group)."""
    _control.clear()
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


def resolve_mesh(mesh_shape: Optional[Dict[str, int]] = None,
                 fsdp: Union[bool, str] = False) -> int:
    """The data axis's size for ``mesh_shape`` (``{"data": -1}``: every
    process) in this process group (1 without one). Only a data axis is
    ported: another axis larger than 1, or ``fsdp`` naming an axis other
    than ``'data'`` (tensor parallelism), raises ``NotImplementedError``."""
    shape = dict(mesh_shape or {"data": -1})
    later = "ROADMAP.md, Queue 1 item 10: spatial and model axes and fsdp over another axis"
    for axis, size in shape.items():
        if axis != "data" and size != 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {size}: the port shards the batch only ({later})")
    if isinstance(fsdp, str) and fsdp != "data":
        raise NotImplementedError(f"fsdp={fsdp!r}: the port shards over 'data' only ({later})")
    world = process_shard_info()[1]
    data = shape.get("data", -1)
    if data not in (-1, world):
        raise ValueError(f"mesh data axis {data} in a group of {world} processes")
    return world


# ---------------------------------------------------------------- collectives --


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the default group, in place (not differentiable)."""
    dist.all_reduce(t)
    return t


def all_reduce_host(values, op=dist.ReduceOp.SUM) -> np.ndarray:
    """A host array (int64 counts, flags) reduced over the control group."""
    t = torch.from_numpy(np.array(values, dtype=np.int64, ndmin=1))
    dist.all_reduce(t, op=op, group=control_group())
    return t.numpy()


def barrier() -> None:
    """Wait for every process, on the control group (no CUDA stream)."""
    dist.barrier(group=control_group())


def mirror_rows(t: torch.Tensor) -> torch.Tensor:
    """The rows that pair with this process's rows when the GLOBAL batch
    (the processes' batches in rank order) is flipped: rank r's partners
    are rank W-1-r's rows, reversed. ``t.flip(0)`` alone."""
    if not is_distributed():
        return t.flip(0)
    rank, world = process_shard_info()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return parts[world - 1 - rank].flip(0)


def broadcast_module(model: nn.Module) -> None:
    """Every parameter and buffer of ``model`` set to rank 0's."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)


def reduce_gradients(grads: Sequence[torch.Tensor]) -> None:
    """Sum ``grads`` over the default group, in place, in buckets of about
    ``BUCKET_BYTES`` (one all-reduce a bucket)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat)
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


# ----------------------------------------------------------------------- fsdp --


def shard_model(model: nn.Module, compute_dtype: torch.dtype) -> nn.Module:
    """ZeRO over the data axis (FSDP2's ``fully_shard``, in place): a unit
    for each backbone stage, each head and the root, the parameters gathered
    in ``compute_dtype`` for the forward and the gradients reduce-scattered
    in float32 and summed (not averaged: the losses divide by global
    counts). Buffers (BatchNorm statistics) stay whole on every process.
    With ``use_checkpoint`` a stage's recompute runs on the parameters
    FSDP2 gathers again before the stage's backward
    (``models/dat.py:checkpointed``)."""
    from torch.distributed.fsdp import FSDPModule, MixedPrecisionPolicy, fully_shard

    from ..models.dat import TransformerStage

    policy = MixedPrecisionPolicy(param_dtype=compute_dtype, reduce_dtype=torch.float32)
    for m in model.modules():
        if isinstance(m, TransformerStage):
            fully_shard(m, mp_policy=policy)
    for name, child in model.named_children():
        if name != "backbone":
            fully_shard(child, mp_policy=policy)
    fully_shard(model, mp_policy=policy)
    for m in model.modules():
        if isinstance(m, FSDPModule):  # a plain SUM (gloo has no AVG or PREMUL_SUM)
            m.set_gradient_divide_factor(1.0)
            m.set_force_sum_reduction_for_comms(True)
    return model


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def local(t: torch.Tensor) -> torch.Tensor:
    """This process's shard of a sharded (DTensor) parameter or gradient,
    or ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def sharded_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``tensors`` (this
    process's shards) over every process, in float32."""
    sq = torch.stack([torch.linalg.vector_norm(local(t).float()) ** 2 for t in tensors]).sum()
    dist.all_reduce(sq)
    return sq.sqrt()


def _param_names(model: nn.Module, optimizer) -> List[str]:
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def full_state(model: nn.Module, optimizer=None, *, everywhere: bool = False):
    """(model state_dict, optimizer state_dict) in the one-process format
    (the optimizer's keyed by parameter index), gathered from the shards
    on every process: held on the CPU by rank 0 (the others get empty
    dicts), or with ``everywhere`` on every process's device. A replicated
    model gives its own."""
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


def load_full_state(model: nn.Module, model_sd, optimizer=None, optim_sd=None) -> None:
    """Load one-process state dicts (every process passes the whole) into
    ``model`` and ``optimizer``, sharded or not."""
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
