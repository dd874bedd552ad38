"""Training: losses, schedules, AdamW, metrics, the steps and the trainers."""

from .losses import (
    cross_entropy_loss,
    label_smoothing_cross_entropy,
    segmentation_loss,
    soft_target_cross_entropy,
)
from .metrics import StreamingIoU, intersect_and_union, miou_from_totals, topk_accuracy
from .optim import make_optimizer, no_decay_names
from .schedules import build_schedule, warmup_cosine_schedule, warmup_poly_schedule
from .train_step import (TrainState, create_train_state, make_cls_metric_step, make_eval_step,
                         make_train_step)
