"""The single-card segmentation train step, in PyTorch.

Counterpart of ``dat_segmentation_tpu/parallel/train_step.py`` on one
device (no mesh, no fsdp: DDP and FSDP come with the scale-out slice).
``create_train_state`` gathers the model, its AdamW optimizer, the
learning-rate schedule, the step count and the ``torch.Generator`` that
every drop path and dropout draws from (seeded with ``cfg.seed + 1`` on
the model's device, as the JAX trainer seeds its key). One call of the
step returned by ``make_train_step`` runs the forward in
``compute_dtype`` with float32 master weights, the loss (pixel CE plus
the weighted auxiliary CE), the backward, the global-norm clip when the
config asks for one, and AdamW at ``schedule(step)``; it updates the
state in place and returns it with the metrics of the JAX step:
``loss``, ``grad_norm`` (of the float32 gradients, before clipping),
``update_ratio`` (||update|| / ||params||) and, unless
``iou_impl='none'``, the per-class ``inter``/``union`` counts. The
metrics stay on the device: reading one waits for the step.

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

from ..models.layers import use_generator
from .losses import segmentation_loss
from .metrics import intersect_and_union
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
    return TrainState(model, optimizer, build_schedule(cfg), 0, generator, opt.grad_clip)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


def make_train_step(
    model: nn.Module,
    *,
    aux_weight: float = 0.4,
    ignore_index: int = 255,
    num_classes: int = 150,
    compute_dtype: torch.dtype = torch.bfloat16,
    iou_impl: str = "bincount",
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step for ``model``: ``step(state, batch) -> (state, metrics)``.

    ``batch``: ``image`` (B, H, W, 3) float32 and ``label`` (B, H, W)
    integer (ignore ``ignore_index``), numpy arrays or tensors; they are
    moved to the model's device. ``iou_impl``: ``'bincount'`` or
    ``'none'`` (no inter/union counters).
    """
    if iou_impl not in ("bincount", "none"):
        raise ValueError(f"iou_impl {iou_impl!r}: 'bincount' or 'none'")
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device

    def forward(image):
        if compute_dtype == torch.float32:
            return model(image)
        cast = {n: p.to(compute_dtype) for n, p in params.items()}
        return torch.func.functional_call(model, cast, (image,))

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        image = torch.as_tensor(batch["image"]).to(device, compute_dtype, non_blocking=True)
        label = torch.as_tensor(batch["label"]).to(device, torch.long, non_blocking=True)
        out = forward(image)
        logits, aux = out if isinstance(out, tuple) else (out, None)
        loss = segmentation_loss(
            logits, aux, label, aux_weight=aux_weight, ignore_index=ignore_index
        )
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
            if iou_impl != "none":
                inter, union, _, _ = intersect_and_union(
                    logits.argmax(-1), label, num_classes, ignore_index=ignore_index
                )
                metrics.update(inter=inter, union=union)
        state.step += 1
        return state, metrics

    return step
