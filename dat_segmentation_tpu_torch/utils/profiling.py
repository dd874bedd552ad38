"""The port's tracing: spans and counters at the layers of the main path.

``span(name)`` marks a layer's host time: ``with span("dat.backbone"):``.
While no ``torch.profiler`` session is active it is one read of torch's own
flag and returns a shared no-op, so the main path calls it unconditionally
and an exported graph holds nothing of it. While a session is active it is
a ``torch.profiler.record_function`` range (a host range on kineto's
timeline, which kineto aligns with the device's activity) and, inside that
range, a ``time.perf_counter_ns`` interval kept by the recorder with its
enclosing span and its thread's outermost span (the request or the step).
Nesting is per thread: the autograd engine runs a CUDA backward on a thread
of its own. ``count(name, n)`` adds to a named counter, again only while a
session is active, under the outermost span of its thread. ``tally()``
collects the counts its body makes on its thread instead, session or none:
a CUDA graph's capture runs its forward's Python once and launches nothing,
so the server keeps what the capture counted and counts it again at each
replay.

The recorder holds one profiler session: it empties itself at the first
span or count that finds a session active after one that found none, so a
session traced after an untraced warm-up holds the session alone.
``recorded()`` returns what it holds, each span with its inclusive and self
time (inclusive less its child spans'). ``trace(log_dir)`` is the
operator's way to see the spans: a Chrome trace with the ``dat.*`` ranges
nested over the operations and kernels.

A host span measures what the host did inside it, including any wait for
the device there (a synchronising call, such as a CUDA ``bincount``'s read
of its size).

The spans on the main path: ``dat.serve`` (``SegInferencer.forward_batch``),
``dat.backbone`` and ``dat.heads`` (``EncoderDecoder``),
``dat.attention`` (``DeformableAttention.forward``), ``dat.step`` and its
parts ``dat.step.forward``, ``dat.step.backward`` and ``dat.step.update``
(``make_train_step``); the counters: ``attn.composite`` (attention calls
that take the composite route instead of K1) and ``serve.graph``
(requests that ``SegInferencer.forward_batch`` serves by replaying a
captured CUDA graph, under their ``dat.serve`` span).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter, defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler  # its _is_profiler_enabled: any session sets it


@dataclass(frozen=True)
class Span:
    """One recorded span: ``perf_counter_ns`` times; ``parent`` the id of
    the enclosing span on its thread (None for a root), ``root`` the id of
    its thread's outermost span (its own for a root)."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: int
    self_ns: int

    @property
    def inclusive_ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclass(frozen=True)
class Recorded:
    """What the recorder holds: the spans in the order they ended, and each
    counter's total under each root id (None: counted outside any span)."""

    spans: List[Span]
    counts: Dict[Tuple[str, Optional[int]], int]


class _Recorder:
    def __init__(self):
        self.live = False  # whether the last span or count found a session active
        self.spans: List[Tuple[str, int, Optional[int], int, int, int]] = []
        self.counts: List[Tuple[str, int, Optional[int]]] = []
        self.ids = itertools.count()
        self.local = threading.local()
        self.lock = threading.Lock()

    def begin(self) -> None:
        """Empty the recorder where a session has started since the last look
        (once: threads that start spans together find it live)."""
        if not self.live:
            with self.lock:
                if not self.live:
                    self.spans, self.counts, self.live = [], [], True

    def stack(self) -> List[int]:
        """The open spans' ids on this thread, outermost first."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_recorder = _Recorder()


class _Live:
    """A span while a session is active: a profiler range and the recorder's
    interval inside it."""

    __slots__ = ("name", "_range", "_stack", "_id", "_parent", "_root", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._stack = stack = _recorder.stack()
        self._id = next(_recorder.ids)
        self._parent = stack[-1] if stack else None
        self._root = stack[0] if stack else self._id
        stack.append(self._id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._stack.pop()
        _recorder.spans.append((self.name, self._id, self._parent, self._root, self._t0, t1))
        return self._range.__exit__(*exc)


_NOOP = contextlib.nullcontext()


def span(name: str):
    """A context manager over a layer's host time: the shared no-op while
    no profiler session is active, else a recorded profiler range."""
    if not _profiler._is_profiler_enabled:
        if _recorder.live:
            _recorder.live = False
        return _NOOP
    _recorder.begin()
    return _Live(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session is active
    (inside ``tally()``: to the tally alone)."""
    tallied = getattr(_recorder.local, "tally", None)
    if tallied is not None:
        tallied[name] += n
        return
    if not _profiler._is_profiler_enabled:
        if _recorder.live:
            _recorder.live = False
        return
    _recorder.begin()
    stack = _recorder.stack()
    _recorder.counts.append((name, n, stack[0] if stack else None))


@contextlib.contextmanager
def tally():
    """Collect the counts that the body makes on this thread into the
    ``Counter`` it yields, whether or not a profiler session is active, and
    keep them from the session's record."""
    outer = getattr(_recorder.local, "tally", None)
    _recorder.local.tally = got = Counter()
    try:
        yield got
    finally:
        _recorder.local.tally = outer


def recorded() -> Recorded:
    """The spans and counters of the last (or the active) profiler session."""
    raw, events = list(_recorder.spans), list(_recorder.counts)
    children: Dict[int, int] = defaultdict(int)
    for _, _, parent, _, t0, t1 in raw:
        if parent is not None:
            children[parent] += t1 - t0
    spans = [Span(name, i, parent, root, t0, t1, t1 - t0 - children[i])
             for name, i, parent, root, t0, t1 in raw]
    counts: Counter = Counter()
    for name, n, root in events:
        counts[(name, root)] += n
    return Recorded(spans=spans, counts=dict(counts))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` (CPU and, on a machine with
    a card, CUDA activities) and write ``trace.json``, a Chrome trace
    (chrome://tracing, Perfetto), into ``log_dir``: ``with trace('dir') as
    prof: step()``; the spans show as ranges over the operations, and
    ``recorded()`` holds them after the body."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    _recorder.live = False  # the body's first span empties the recorder
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
