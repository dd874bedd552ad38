"""Graceful preemption: on SIGTERM, one last resumable checkpoint.

Counterpart of ``dat_segmentation_tpu/train/preemption.py``. Schedulers
deliver SIGTERM ahead of eviction; the trainer polls ``should_checkpoint``
every iteration and, on notice, writes a checkpoint at the current
iteration and returns, so ``--resume`` continues from it. The handler is
installed only on the main thread, and ``close`` puts the previous one
back.

Inside a ``torch.distributed`` process group the signal may reach one rank
only: each poll takes the MAX of every rank's flag (one int64 all-reduce
over the gloo control group, ``parallel/mesh.py``), so all ranks save at
the same step and stop together.
"""

from __future__ import annotations

import signal
import threading

import torch.distributed as dist

from ..parallel import mesh


class PreemptionGuard:
    """Poll ``should_checkpoint(step)`` once per training iteration."""

    def __init__(self):
        self._flag = False
        self._prev = None
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        self._flag = True

    def should_checkpoint(self, step: int) -> bool:
        """True once a signal has arrived (at any rank of a process group:
        every rank calls this at each iteration)."""
        if mesh.is_distributed():
            return bool(mesh.all_reduce_host(int(self._flag), op=dist.ReduceOp.MAX)[0])
        return self._flag

    def close(self):
        """Restore the previous SIGTERM handler."""
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
