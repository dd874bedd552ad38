"""Graceful preemption: on SIGTERM, one last resumable checkpoint.

Counterpart of ``dat_segmentation_tpu/train/preemption.py`` for one
process. Schedulers deliver SIGTERM ahead of eviction; the trainer polls
``should_checkpoint`` every iteration and, on notice, writes a checkpoint
at the current iteration and returns, so ``--resume`` continues from it.
The handler is installed only on the main thread, and ``close`` puts the
previous one back.

With ``torch.distributed`` initialised over more than one rank the guard
is inert: a flag local to the signalled rank would make it save alone
while the others step on. The JAX package stays inert in that case too
when it has no coordination service; a step that every rank agrees on
comes with the port's scale-out (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import signal
import threading

import torch.distributed as dist


class PreemptionGuard:
    """Poll ``should_checkpoint(step)`` once per training iteration."""

    def __init__(self):
        self._flag = False
        self._prev = None
        self._inert = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
        if not self._inert and threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        self._flag = True

    def should_checkpoint(self, step: int) -> bool:
        """True once a signal has arrived (never when inert)."""
        return not self._inert and self._flag

    def close(self):
        """Restore the previous SIGTERM handler."""
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
