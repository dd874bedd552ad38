"""Profiling and timing helpers, in PyTorch.

Counterpart of ``dat_segmentation_tpu/utils/profiling.py``: a device trace
(``torch.profiler``, written as a Chrome trace), named regions in it, a
call's operation count and memory, an images/s meter with warm-up, and a
seconds-a-call timer that waits for the device. Nothing on the main path
calls this module; ``chip_smoke.py`` and ``tools/step_time.py`` time the
port with CUDA events of their own.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from ..ops import deform_attn as _k1  # registers dat::deform_attn_fwd
from ..ops import x_block as _k3  # registers dat::x_block_fwd


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` (CPU and, on a machine with
    a card, CUDA activities) and write ``trace.json``, a Chrome trace
    (chrome://tracing, Perfetto), into ``log_dir``: ``with trace('dir') as
    prof: step()``; ``prof.key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    """A named region that shows up in the trace's timeline."""
    return torch.profiler.record_function(name)


def _k1_flops(q, k, v, pos, table, n_groups, scale, hn, wn, out_shape=None):
    """K1's products, as PERF.md's bound counts them: q·kᵀ and P·v, two
    multiply-adds a (query, sample, channel): 4·BG·H·W·Ns·Cg."""
    BG, H, W, Cg = q
    return 4 * BG * H * W * k[1] * Cg


def _k3_flops(x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2, with_lpu, out_shape=None):
    """K3's products: fc1 and fc2 (2·n·2·C·E) and the depthwise taps (the
    LPU's 3x3 and the window's k x k on C channels, the MLP's 3x3 on E),
    n = B·H·W."""
    B, H, W, C = x
    n, E = B * H * W, wf1[0]
    taps = (9 if with_lpu and w3 is not None else 0) + (w7[-1] ** 2 if w7 is not None else 0)
    return 2 * n * 2 * C * E + 2 * n * (C * taps + 9 * E)


FLOP_FORMULAS = {torch.ops.dat.deform_attn_fwd: _k1_flops, torch.ops.dat.x_block_fwd: _k3_flops}


def compiled_stats(fn: Callable, *args) -> dict:
    """One call of ``fn(*args)``, counted (the JAX ``compiled_stats``).

    * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
      the products it knows (matmuls, convolutions, attention), plus the
      ``dat::`` ops by ``FLOP_FORMULAS`` (K1 and K3 without grad). A kernel
      launched inside an autograd Function (K1 with its log-sum-exp and K2
      under grad, K3's ``XBlockFunction``) runs outside the dispatcher and
      is not counted: count without grad.
    * ``argument_bytes`` and ``output_bytes``: the tensors ``args`` and the
      result hold.
    * ``peak_bytes`` (CUDA arguments only): the allocator's peak during the
      call above what was allocated before it.

    XLA's ``bytes accessed`` and ``temp_size_in_bytes`` have no PyTorch
    counterpart and are left out, never estimated.
    """
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(args))
    if cuda:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)
    with counter:
        out = fn(*args)
    stats = {"flops": float(counter.get_total_flops()), "argument_bytes": nbytes(args),
             "output_bytes": nbytes(out)}
    if cuda:
        torch.cuda.synchronize()
        stats["peak_bytes"] = torch.cuda.max_memory_allocated() - before
    return stats


class Throughput:
    """images/s meter with warm-up: the first ``warmup`` steps are not
    counted, the clock starts at the last of them."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.reset()

    def reset(self):
        self._count = 0
        self._items = 0
        self._t0 = None

    def step(self, n_items: int):
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()
            self._items = 0
        elif self._count > self.warmup:
            self._items += n_items

    @property
    def rate(self) -> Optional[float]:
        if self._t0 is None or self._items == 0:
            return None
        return self._items / (time.perf_counter() - self._t0)


def _synchronize() -> None:
    """Wait for the card, where the process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Seconds a call of ``fn(*args)``, after ``warmup`` calls: the host
    clock around ``iters`` calls that ends when the device has finished
    the last (CUDA launches return before their work is done)."""
    for _ in range(warmup):
        fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _synchronize()
    return (time.perf_counter() - t0) / iters
