"""A window under ``torch.profiler``, reduced to what the per-layer metrics
and the result's ``breakdown`` read.

The device's operations (kernels, copies, sets) come from the profiler's
CUDA events; the host's ranges from its CPU events, the benchmark's own
``record_function`` spans among them. ``busy_s`` is the union of the device
operations' intervals inside the window; an idle gap between them is named
by the innermost host range that covers its middle, which says what the host
was doing while the card waited.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "bench.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]  # (name, start s, duration s) in the window
    gaps: List[Tuple[str, float]]  # (host range, idle s), one a gap
    range_device_s: Dict[str, float] = field(default_factory=dict)  # host range -> device s

    def device_s(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(d for n, _, d in self.kernels if part in n)

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = defaultdict(float)
        for n, _, d in self.kernels:
            ops[n[:160]] += d
        idle: Dict[str, float] = defaultdict(float)
        for n, d in self.gaps:
            idle[n[:160]] += d
        by = lambda kv: -kv[1]  # noqa: E731
        return {"device_ops": [[n, s] for n, s in sorted(ops.items(), key=by)[:top]],
                "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=by)[:top]]}


def run_traced(body: Callable[[], None], sync: Callable[[], None],
               ranges: Tuple[str, ...] = ()) -> Trace:
    """Run ``body`` (which ends in ``sync``) under the profiler inside a
    ``bench.window`` range and reduce the trace. ``ranges``: host range
    names whose kernels' device time is summed (``range_device_s``): the
    operations that run inside the range's span on the device's track."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            body()
            sync()
    events = prof.events()
    window = [e for e in events if e.name == WINDOW]
    if not window:
        raise RuntimeError("the profiler recorded no window range")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    # a host range also shows on the device's track (kineto's GPU user
    # annotation, from its first kernel to its last): not an operation
    ranged = {e.name for e in events if e.device_type != DeviceType.CUDA
              and getattr(e, "is_user_annotation", False)} | {WINDOW} | set(ranges)
    dev, host, spans = [], [], defaultdict(list)
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in ranged or e.name.startswith(
                    "bench."):
                spans[e.name].append((tr.start, tr.end))
            elif tr.end > w0 and tr.start < w1 and tr.end > tr.start:
                dev.append((e.name, max(tr.start, w0), min(tr.end, w1)))
        elif e.name != WINDOW and tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    range_device_s = {}
    for name in ranges:
        if spans[name]:
            range_device_s[name] = sum(t - s for _, s, t in dev if _inside(spans[name], s, t)) / 1e6
        else:  # no span on the device's track: the kernels the profiler links to the range
            range_device_s[name] = sum(getattr(e, "device_time_total", 0.0) for e in events
                                       if e.name == name and e.device_type != DeviceType.CUDA) / 1e6
    dev.sort(key=lambda t: t[1])
    busy, gaps, at = 0.0, [], w0
    merged: List[Tuple[float, float]] = []
    for _, s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t))
        else:
            merged.append((s, t))
    host.sort()
    starts = [h[0] for h in host]
    bench = [h for h in host if h[2].startswith("bench.")]
    for s, t in merged + [(w1, w1)]:
        if s > at:
            mid = (at + s) / 2.0
            gaps.append((_covering(host, starts, mid) or _covering(bench, [h[0] for h in bench],
                                                                   mid) or "none",
                         (s - at) / 1e6))
        busy += max(t - s, 0.0)
        at = max(at, t)
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                 kernels=[(n, s / 1e6, (t - s) / 1e6) for n, s, t in dev], gaps=gaps,
                 range_device_s=range_device_s)


def _inside(intervals, s: float, t: float) -> bool:
    """Whether [s, t] lies within one of ``intervals``."""
    return any(a <= s and t <= b for a, b in intervals)


def _covering(host, starts, t: float) -> Optional[str]:
    """The shortest of the last few thousand host ranges that start before
    time ``t`` (us) and hold it, or None."""
    best: Optional[Tuple[float, str]] = None
    i = bisect.bisect_right(starts, t)
    # ranges that start before t; the innermost is the shortest that ends after t
    for s, e, name in host[max(0, i - 4000):i]:
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return None if best is None else best[1]
