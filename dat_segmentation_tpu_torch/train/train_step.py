"""The train steps (segmentation and classification) and the classifier's
metric step, in PyTorch, on one card or over the processes of a group.

Counterpart of ``dat_segmentation_tpu/parallel/train_step.py``.
``create_train_state`` gathers the model, its AdamW optimizer, the
learning-rate schedule, the step count, the ``torch.Generator`` that
every drop path and dropout draws from (seeded with ``cfg.seed + 1`` on
the model's device, as the JAX trainer seeds its key) and, for a
classifier (a ``ClsHead`` config), the host-side ``MixupSampler``
(``data/mixup.py``, seeded with ``cfg.seed + 1`` too; None otherwise). One call of the step returned by
``make_train_step`` runs the forward in ``compute_dtype`` with float32
master weights, the loss, the backward, the global-norm clip when the
config asks for one, and AdamW at ``schedule(step)``; it updates the
state in place and returns it with the metrics of the JAX step:
``loss``, ``grad_norm`` (of the float32 gradients, before clipping),
``update_ratio`` (||update|| / ||params||), and per task:

* ``task='seg'``: pixel CE plus the weighted auxiliary CE; unless
  ``iou_impl='none'``, the per-class ``inter``/``union`` counts.
* ``task='cls'``: with ``mixup``, the batch mixed by the state's sampler's
  draws and the soft-target CE, ``acc1`` against the targets' argmax;
  without, the label-smoothing CE (0.1, timm's) and ``acc1`` against the
  labels.

The metrics stay on the device: reading one waits for the step.
``make_cls_metric_step`` is the eval forward in ``compute_dtype`` and the
int32 ``[hits1, hits5, total]`` of a batch with a ``valid`` mask;
``make_eval_step`` the eval forward's logits.

bf16 compute: like the JAX step (``_cast``), the port casts every
parameter to ``compute_dtype`` for the forward (``torch.func.
functional_call`` on bf16 copies; the copies are differentiable, so the
gradients land on the float32 masters) and runs the activations in it.
``torch.autocast`` would instead choose a dtype per operator (float32
for LayerNorm, softmax and the losses, bf16 for products), so the
forward would not be the JAX package's, and the deformable-attention
kernels would see float32 and bf16 inputs mixed. BatchNorm statistics
are taken in float32 either way, and the running statistics stay
float32 buffers.

Inside a ``torch.distributed`` process group (``parallel/mesh.py``) the
step is the JAX package's over the GLOBAL batch (the data coordinates'
batches in order) on the mesh ``cfg.mesh_shape`` (``{"data": X, "model":
Y, "spatial": S}``, any of them): ``create_train_state`` makes the layout
(``resolve_mesh``), broadcasts rank 0's parameters and buffers, and with
``cfg.fsdp`` True (or ``'data'``) shards the model over the data groups,
with ``cfg.fsdp='spatial'`` over the spatial groups (replicated over the
data groups: ``shard_model``, FSDP2, which gathers the parameters in
``compute_dtype`` for the forward in place of the cast copies, whose
``functional_call`` would see sharded parameters), or with
``cfg.fsdp='model'`` splits it over the model groups
(``parallel/model_axis.py:shard_model_axis``: tensor parallelism, the cast
copies of this rank's slices). The model's BatchNorms, dropout and the
losses take the global batch over the data group (see
``parallel/mesh.py``); after the backward the step sums the float32
gradients over the data group in buckets (FSDP2 reduce-scatters them
itself), and under the model axis the gradients of the whole leaves that
split compute reads (the offset nets, ``log_cpb``'s MLP) over the model
group too, and on any mesh with a model axis the gradients of the leaves
that stay whole (those the JAX rule keeps whole too: below its 2^14
elements or with no dim that divides by Y; every leaf where the model
axis does not split the model) are set to model rank 0's (the peers
compute them alike, but K2's float32 atomics round them otherwise on
each), so that the peers' replicas stay equal bit for bit; a leaf held as
a slice (``parallel/model_axis.py``) has one owner of each slice and takes
no such rule. So ``grad_norm``, the clip and ``update_ratio`` read the
global gradient (over the model axis: the split and held leaves' squares
summed over the peers, the whole ones once; under FSDP2 the shards'
squares over the shards' group, ``mesh.shard_group``), and the metrics
are global on every process: ``loss`` and ``acc1`` over the global batch,
``inter``/``union`` summed in int64 over the data group. Not wrapping the
model in ``DistributedDataParallel`` is deliberate: the cast forward's
``functional_call`` bypasses DDP's ``forward``, so its reducer would never
run. The gradient reduction runs after the backward, not beside it
(ROADMAP.md, Queue 2). The metric step's ``[hits1, hits5, total]`` are
summed over the data group.

On a mesh with a spatial axis (``parallel/spatial.py``) every step still
takes the data coordinate's batch: each spatial peer keeps its rows of
each image and label (``ValueError`` where S does not divide H) and runs
the model on them (``rows``). The gradients are summed over data ×
spatial of the rank's model coordinate (``Layout.rows_group``: each
peer's are parts, the module docstring of ``parallel/spatial.py`` says
why; under FSDP2 over the data axis the reduce-scattered shards are then
summed over the spatial group, over the spatial axis its HSDP sums both),
and so are the loss and the IoU counts; acc1 and the metric step's counts,
of the replicated logits, over the data group. Beside a model axis the
split modules run on the row shards, the model peers of one spatial
coordinate holding the same rows. Mixup's box falls on the rows it
covers. ``make_eval_step`` gathers the logits' rows and then the data
coordinates' batches: the global batch's logits on every process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..data.mixup import LABEL_SMOOTHING, MixupSampler, mixup_cutmix
from ..models.layers import use_generator
from ..parallel import mesh, spatial
from ..utils import profiling
from .losses import label_smoothing_cross_entropy, segmentation_loss, soft_target_cross_entropy
from .metrics import intersect_and_union, topk_hits
from .optim import make_optimizer
from .schedules import build_schedule


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int
    generator: torch.Generator
    grad_clip: Optional[float] = None
    mixup: Optional[MixupSampler] = None


def create_train_state(model: nn.Module, cfg) -> TrainState:
    """The train state of ``model`` (its weights as they are) under the
    optimizer and schedule of ``cfg`` (a ``TrainConfig``). Inside a
    process group: rank 0's weights on every process, and with
    ``cfg.fsdp`` the model sharded over the data or the spatial axis or
    split over the model axis (in place) before the optimizer sees its
    parameters. fsdp
    over an axis the mesh lacks, or of size 1 (one process), raises
    ``ValueError``."""
    device = next(model.parameters()).device
    layout = mesh.resolve_mesh(cfg.mesh_shape, cfg.fsdp)
    if mesh.is_distributed():
        mesh.broadcast_module(model)
        if cfg.fsdp == "model":
            from ..parallel.model_axis import shard_model_axis

            shard_model_axis(model, layout.model_axis)
        elif cfg.fsdp:
            mesh.shard_model(model, torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
                             "spatial" if cfg.fsdp == "spatial" else "data")
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    use_generator(model, generator)
    opt = cfg.optimizer
    optimizer = make_optimizer(
        model, lr=opt.lr, betas=opt.betas, weight_decay=opt.weight_decay,
        no_decay_keys=opt.no_decay_keys,
    )
    # the classifier's mixup draws; a segmentor draws none
    mixup = MixupSampler(cfg.seed + 1) if cfg.model.decode_head.type == "ClsHead" else None
    return TrainState(model, optimizer, build_schedule(cfg), 0, generator, opt.grad_clip, mixup)


def global_norm(tensors: Iterable[torch.Tensor], sharded: bool = False,
                split: Optional[Sequence[bool]] = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32; over every
    process's shards when ``sharded`` (FSDP's DTensors, over ``group``:
    ``mesh.shard_group``) or ``split`` (a model split over the model axis:
    True for its split leaves)."""
    if sharded or split is not None:
        return mesh.sharded_norm(list(tensors), split, group)
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


def _forward_in(model: nn.Module, compute_dtype: torch.dtype) -> Callable:
    """``model``'s forward with its parameters cast to ``compute_dtype`` (the
    JAX ``_cast``): differentiable bf16 copies through
    ``torch.func.functional_call``, the float32 masters untouched. A
    sharded model casts as FSDP2 gathers (``shard_model``). ``rows``: the
    image is a row shard (the spatial axis)."""
    params = dict(model.named_parameters())

    def forward(image, rows=None):
        kw = {} if rows is None else {"rows": rows}
        if compute_dtype == torch.float32 or mesh.is_sharded(model):
            return model(image, **kw)
        cast = {n: p.to(compute_dtype) for n, p in params.items()}
        return torch.func.functional_call(model, cast, (image,), kw)

    return forward


def _own_rows(image: torch.Tensor, *labels: torch.Tensor):
    """This spatial peer's rows of a data coordinate's images (and (B, H,
    ...) labels) and their layout; all of them and None without a spatial
    axis."""
    axis = mesh.layout().spatial_axis
    if axis is None:
        return (image, None) + labels
    rows = spatial.image_rows(image.shape[1], axis)
    return (spatial.keep_rows(image, rows), rows) + tuple(
        spatial.keep_rows(t, rows) if t.ndim >= 3 else t for t in labels)


def make_train_step(
    model: nn.Module,
    *,
    task: str = "seg",
    aux_weight: float = 0.4,
    ignore_index: int = 255,
    num_classes: int = 150,
    compute_dtype: torch.dtype = torch.bfloat16,
    mixup: bool = False,
    iou_impl: str = "bincount",
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step for ``model``: ``step(state, batch) -> (state, metrics)``.

    ``batch``: ``image`` (B, H, W, 3) float32 and ``label``, numpy arrays or
    tensors, moved to the model's device: (B, H, W) integer (ignore
    ``ignore_index``) for ``task='seg'``, (B,) integer or (B, num_classes)
    soft targets for ``task='cls'``. ``iou_impl``: ``'bincount'`` or
    ``'none'`` (no inter/union counters; seg only). With ``mixup`` (cls)
    the step draws from ``state.mixup``.
    """
    if task not in ("seg", "cls"):
        raise ValueError(f"task {task!r}: 'seg' or 'cls'")
    if iou_impl not in ("bincount", "none"):
        raise ValueError(f"iou_impl {iou_impl!r}: 'bincount' or 'none'")
    names, plist = zip(*model.named_parameters())
    device = plist[0].device
    forward = _forward_in(model, compute_dtype)
    distributed, sharded = mesh.is_distributed(), mesh.is_sharded(model)
    lay = mesh.layout()
    shards = mesh.shard_group(model) if sharded else None
    # fsdp over the data axis beside a spatial one: the spatial peers'
    # gradient shards are parts (over 'spatial', FSDP2's HSDP sums both axes)
    spatial_parts = sharded and lay.spatial > 1 and model.fsdp_axis == "data"
    axis = mesh.model_axis_of(model)
    # over the model axis: the split leaves (and those held as slices), and
    # the whole ones split compute reads
    split = None if axis is None else [n in model.model_axis_dims for n in names]
    partial = [] if axis is None else [p for n, p in zip(names, plist)
                                       if n in model.model_axis_partial]
    # the leaves that stay whole (those the JAX rule keeps whole too; every
    # leaf of a model the model axis does not split): each model peer
    # computed the same gradient, but a kernel's float32 atomics (K2) may
    # round it otherwise on each
    peers = mesh.layout().model_group if distributed else None
    whole = [p for n, p in zip(names, plist) if axis is None or (
        n not in model.model_axis_dims and n not in model.model_axis_partial)]
    first_peer = None if peers is None else dist.get_global_rank(peers, 0)

    def seg_loss(image, label, rows):
        out = forward(image, rows)
        logits, aux = out if isinstance(out, tuple) else (out, None)
        loss = segmentation_loss(
            logits, aux, label, aux_weight=aux_weight, ignore_index=ignore_index
        )
        return loss, logits, label

    def cls_loss(state, image, label, rows):
        if mixup and label.ndim == 1:
            H = image.shape[1] if rows is None else rows.H
            draws = state.mixup.draw(H, image.shape[2])
            image, label = mixup_cutmix(image, label, draws, num_classes=num_classes, rows=rows)
        logits = forward(image, rows)
        if mixup and label.ndim == 2:
            return soft_target_cross_entropy(logits, label), logits, label.argmax(-1)
        loss = label_smoothing_cross_entropy(logits, label, smoothing=LABEL_SMOOTHING)
        return loss, logits, label

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with profiling.span("dat.step"):
            with profiling.span("dat.step.forward"):
                model.train()
                image = torch.as_tensor(batch["image"]).to(device, compute_dtype, non_blocking=True)
                label = torch.as_tensor(batch["label"]).to(device, non_blocking=True)
                label = label.float() if label.is_floating_point() else label.long()
                image, rows, label = _own_rows(image, label)
                if task == "seg":
                    loss, logits, hard = seg_loss(image, label, rows)
                else:
                    loss, logits, hard = cls_loss(state, image, label, rows)
            with profiling.span("dat.step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with profiling.span("dat.step.update"), torch.no_grad():
                # a parameter the loss does not reach (a no_off block's offset
                # net) takes a zero gradient, as jax.grad gives it: AdamW decays it
                for p in plist:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if distributed and not sharded:
                    mesh.reduce_gradients([p.grad for p in plist], group=lay.rows_group)
                elif spatial_parts:
                    mesh.reduce_gradients([mesh.local(p.grad) for p in plist],
                                          group=lay.spatial_group)
                if partial:
                    mesh.reduce_gradients([p.grad for p in partial], group=axis.group)
                if peers is not None:  # model rank 0's, so that the peers' replicas stay equal
                    mesh.reduce_gradients([mesh.local(p.grad) for p in whole], group=peers,
                                          src=first_peer)
                grads = [mesh.local(p.grad) for p in plist]
                grad_norm = global_norm(grads, sharded, split, shards)
                param_norm = global_norm([mesh.local(p) for p in plist], sharded, split, shards)
                before = [mesh.local(p).detach().clone() for p in plist]
                if state.grad_clip is not None:
                    # optax.clip_by_global_norm: g * clip / norm where norm > clip
                    factor = torch.clamp(state.grad_clip / grad_norm, max=1.0)
                    torch._foreach_mul_(grads, factor)
                for group in state.optimizer.param_groups:
                    group["lr"] = state.schedule(state.step)
                state.optimizer.step()
                update_norm = global_norm(
                    torch._foreach_sub([mesh.local(p).detach() for p in plist], before), sharded,
                    split, shards)
                metrics = {
                    "loss": loss.detach(),
                    "grad_norm": grad_norm,
                    "update_ratio": update_norm / (param_norm + 1e-12),
                }
                if task == "cls":
                    metrics["acc1"] = (logits.argmax(-1) == hard).float().mean()
                elif iou_impl != "none":
                    inter, union, _, _ = intersect_and_union(
                        logits.argmax(-1), hard, num_classes, ignore_index=ignore_index
                    )
                    metrics.update(inter=inter, union=union)
                if distributed:
                    _global_metrics(metrics, task)
            state.step += 1
            return state, metrics

    return step


def _global_metrics(metrics: Dict[str, torch.Tensor], task: str) -> None:
    """The step's metrics over the global batch, in place: the loss (each
    process's share of the global mean) summed and the IoU counts (of row
    shards) summed in int64, over data × spatial; acc1 (of replicated
    logits) averaged over the data group (model and spatial peers hold the
    same batch rows; equal batches)."""
    world = mesh.process_shard_info()[1]
    metrics["loss"] = mesh.all_reduce(metrics["loss"].float(), rows=True)
    if task == "cls":
        metrics["acc1"] = mesh.all_reduce(metrics["acc1"] / world)
    elif "inter" in metrics:
        counts = mesh.all_reduce(torch.stack([metrics["inter"], metrics["union"]]), rows=True)
        metrics.update(inter=counts[0], union=counts[1])


def make_cls_metric_step(
    model: nn.Module, *, compute_dtype: torch.dtype = torch.bfloat16
) -> Callable[..., torch.Tensor]:
    """``fn(image, label, valid) -> int32 [hits1, hits5, total]`` on the
    model's device: the eval forward in ``compute_dtype``, its logits taken
    in float32, the hits counted over the rows where ``valid`` (a padded
    tail batch counts only its real rows); summed over the data group, so
    every process gets the global counts."""
    device = next(model.parameters()).device
    forward = _forward_in(model, compute_dtype)

    def fn(image, label, valid) -> torch.Tensor:
        model.eval()
        image = torch.as_tensor(image).to(device, compute_dtype, non_blocking=True)
        label = torch.as_tensor(label).to(device, torch.long, non_blocking=True)
        valid = torch.as_tensor(valid).to(device, torch.bool, non_blocking=True)
        image, rows = _own_rows(image)
        with torch.no_grad():
            hits = topk_hits(forward(image, rows).float(), label, valid)
        return mesh.all_reduce(hits) if mesh.is_distributed() else hits

    return fn


def make_eval_step(
    model: nn.Module, *, compute_dtype: torch.dtype = torch.bfloat16
) -> Callable[..., torch.Tensor]:
    """``fn(image) -> float32 logits`` of the eval forward in
    ``compute_dtype`` (the JAX ``make_eval_step``): ``image`` is the data
    coordinate's batch (B, H, W, 3), each spatial peer runs its rows, and
    every process gets the global batch's whole logits (the data
    coordinates' batches in order): (B·X, H, W, classes) of a segmentor,
    (B·X, classes) of a classifier."""
    device = next(model.parameters()).device
    forward = _forward_in(model, compute_dtype)

    def fn(image) -> torch.Tensor:
        model.eval()
        image = torch.as_tensor(image).to(device, compute_dtype, non_blocking=True)
        image, rows = _own_rows(image)
        with torch.no_grad():
            out = forward(image, rows).float()
            if rows is not None and out.ndim == 4:
                out = spatial.gather_rows(out, rows)
            if mesh.is_distributed() and mesh.process_shard_info()[1] > 1:
                out = mesh.gather_tensor(out, 0, mesh.ModelAxis(
                    *mesh.process_shard_info(), mesh.layout().data_group))
        return out

    return fn
