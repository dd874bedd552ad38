"""Scale-out: data parallelism, ZeRO (fsdp), the model axis and the
spatial axis over ``torch.distributed``; the steps, as the JAX package's
``parallel`` exports them (loaded at first use: ``train/`` imports this
package)."""

from .mesh import (
    destroy_distributed,
    init_distributed,
    local_batch_size,
    process_shard_info,
    resolve_mesh,
)

_STEPS = ("TrainState", "create_train_state", "make_cls_metric_step", "make_eval_step",
          "make_train_step")


def __getattr__(name):
    if name not in _STEPS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from ..train import train_step

    return getattr(train_step, name)
