"""The single-card train steps (segmentation and classification) and the
classifier's metric step, in PyTorch.

Counterpart of ``dat_segmentation_tpu/parallel/train_step.py`` on one
device (no mesh, no fsdp: DDP and FSDP come with the scale-out slice).
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
int32 ``[hits1, hits5, total]`` of a batch with a ``valid`` mask.

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn

from ..data.mixup import LABEL_SMOOTHING, MixupSampler, mixup_cutmix
from ..models.layers import use_generator
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
    optimizer and schedule of ``cfg`` (a ``TrainConfig``)."""
    device = next(model.parameters()).device
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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


def _forward_in(model: nn.Module, compute_dtype: torch.dtype) -> Callable:
    """``model``'s forward with its parameters cast to ``compute_dtype`` (the
    JAX ``_cast``): differentiable bf16 copies through
    ``torch.func.functional_call``, the float32 masters untouched."""
    params = dict(model.named_parameters())

    def forward(image):
        if compute_dtype == torch.float32:
            return model(image)
        cast = {n: p.to(compute_dtype) for n, p in params.items()}
        return torch.func.functional_call(model, cast, (image,))

    return forward


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
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    forward = _forward_in(model, compute_dtype)

    def seg_loss(image, label):
        out = forward(image)
        logits, aux = out if isinstance(out, tuple) else (out, None)
        loss = segmentation_loss(
            logits, aux, label, aux_weight=aux_weight, ignore_index=ignore_index
        )
        return loss, logits, label

    def cls_loss(state, image, label):
        if mixup and label.ndim == 1:
            draws = state.mixup.draw(image.shape[1], image.shape[2])
            image, label = mixup_cutmix(image, label, draws, num_classes=num_classes)
        logits = forward(image)
        if mixup and label.ndim == 2:
            return soft_target_cross_entropy(logits, label), logits, label.argmax(-1)
        loss = label_smoothing_cross_entropy(logits, label, smoothing=LABEL_SMOOTHING)
        return loss, logits, label

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        image = torch.as_tensor(batch["image"]).to(device, compute_dtype, non_blocking=True)
        label = torch.as_tensor(batch["label"]).to(device, non_blocking=True)
        label = label.float() if label.is_floating_point() else label.long()
        if task == "seg":
            loss, logits, hard = seg_loss(image, label)
        else:
            loss, logits, hard = cls_loss(state, image, label)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()

        with torch.no_grad():
            live = [p for p in params.values() if p.grad is not None]
            grads = [p.grad for p in live]
            grad_norm = global_norm(grads)
            param_norm = global_norm(params.values())
            before = [p.detach().clone() for p in live]
            if state.grad_clip is not None:
                # optax.clip_by_global_norm: g * clip / norm where norm > clip
                factor = torch.clamp(state.grad_clip / grad_norm, max=1.0)
                torch._foreach_mul_(grads, factor)
            for group in state.optimizer.param_groups:
                group["lr"] = state.schedule(state.step)
            state.optimizer.step()
            update_norm = global_norm(torch._foreach_sub([p.detach() for p in live], before))
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
        state.step += 1
        return state, metrics

    return step


def make_cls_metric_step(
    model: nn.Module, *, compute_dtype: torch.dtype = torch.bfloat16
) -> Callable[..., torch.Tensor]:
    """``fn(image, label, valid) -> int32 [hits1, hits5, total]`` on the
    model's device: the eval forward in ``compute_dtype``, its logits taken
    in float32, the hits counted over the rows where ``valid`` (a padded
    tail batch counts only its real rows)."""
    device = next(model.parameters()).device
    forward = _forward_in(model, compute_dtype)

    def fn(image, label, valid) -> torch.Tensor:
        model.eval()
        image = torch.as_tensor(image).to(device, compute_dtype, non_blocking=True)
        label = torch.as_tensor(label).to(device, torch.long, non_blocking=True)
        valid = torch.as_tensor(valid).to(device, torch.bool, non_blocking=True)
        with torch.no_grad():
            return topk_hits(forward(image).float(), label, valid)

    return fn
