"""DAT-Segmentation in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``dat_segmentation_tpu`` (the JAX/TPU package, which stays in
the repository as the reference). Module names mirror the JAX package;
public functions keep its NHWC layout. Entry points (``build_model``,
``build_model_from_config``, ``SegInferencer``) run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel is replaced by its plain
PyTorch version, which is how the tests hold the port to the JAX package.
``create_train_state`` and ``make_train_step`` train a segmentor or the
classifier on one card, or over the processes of a ``torch.distributed``
group (``parallel/``: data parallel, ``fsdp=True`` for ZeRO, the model
and the spatial mesh axes). ``serving`` exports a segmentor or the
classifier with ``torch.export`` and serves the artifact without the
model code.
"""

import importlib

# Loaded at first use, so that a module that needs none of them (the
# serving loader, which must not import the model code) imports the package
# without them.
_LAZY = {
    "get_config": ".configs",
    "list_configs": ".configs",
    "SegInferencer": ".eval.inference",
    "build_model": ".models.builder",
    "build_model_from_config": ".models.builder",
    "register_head": ".models.builder",
    "TrainState": ".train.train_step",
    "create_train_state": ".train.train_step",
    "make_train_step": ".train.train_step",
    "make_eval_step": ".train.train_step",
}
__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value
