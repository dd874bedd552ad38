"""The program's own spans and counters, read a root at a time.

The port's tracing module (``dat_segmentation_tpu_torch/utils/profiling.py``)
records, while a profiler session is active, each span's host interval
(``time.perf_counter_ns`` inside its ``torch.profiler`` range) with its
enclosing span and its thread's outermost span, the root: a request's
``dat.serve`` or a step's ``dat.step``; and each counter under its root. In
a ``--trace 1`` run the recorder holds the traced window (the warm-up runs
untraced). A metric is the median over the window's roots of what each
root holds. A program without the recorder, or a window in which it holds
nothing, gives None.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Optional, Tuple


def recorded():
    """The recorder's contents, or None where the program has no recorder or
    it holds nothing."""
    try:
        from dat_segmentation_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded", None)
    rec = read() if read is not None else None
    return rec if rec is not None and (rec.spans or rec.counts) else None


def _roots(rec, root: str):
    return [s.id for s in rec.spans if s.name == root and s.root == s.id]


def host_ms(root: str, name: str, less: Tuple[str, ...] = ()) -> Optional[float]:
    """The median over the window's ``root`` spans of the host milliseconds
    of the spans named ``name`` in each: their inclusive time less that of
    their children named in ``less``."""
    rec = recorded()
    roots = [] if rec is None else _roots(rec, root)
    if not roots:
        return None
    taken = defaultdict(int)
    for s in rec.spans:
        if s.name in less and s.parent is not None:
            taken[s.parent] += s.inclusive_ns
    per = dict.fromkeys(roots, 0)
    for s in rec.spans:
        if s.name == name and s.root in per:
            per[s.root] += s.inclusive_ns - taken[s.id]
    return statistics.median(per.values()) / 1e6


def counted(root: str, name: str) -> Optional[float]:
    """The median over the window's ``root`` spans of the counter ``name``
    under each."""
    rec = recorded()
    roots = [] if rec is None else _roots(rec, root)
    if not roots:
        return None
    return float(statistics.median(rec.counts.get((name, r), 0) for r in roots))
