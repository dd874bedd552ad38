"""DAT-Segmentation in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``dat_segmentation_tpu`` (the JAX/TPU package, which stays in
the repository as the reference). Module names mirror the JAX package;
public functions keep its NHWC layout. Entry points (``build_model``,
``SegInferencer``) run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel is replaced by its plain
PyTorch version, which is how the tests hold the port to the JAX package.
``create_train_state`` and ``make_train_step`` train a segmentor or the
classifier on one card, or over the processes of a ``torch.distributed``
group (``parallel/``: data parallel, ``fsdp=True`` for ZeRO).
"""

from .configs import get_config, list_configs
from .eval.inference import SegInferencer
from .models.builder import build_model
from .train.train_step import TrainState, create_train_state, make_train_step
