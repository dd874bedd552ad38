"""The port's ``utils/profiling.py`` on the CPU: ``span`` and ``count`` off
and under ``torch.profiler``, the recorder against the profiler's own
events, self times, the spans and the counter on the main path (a small
segmentor's ``forward_batch`` and train step) and the trace file."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from dat_segmentation_tpu_torch import (
    SegInferencer,
    build_model,
    create_train_state,
    get_config,
    make_train_step,
)
from dat_segmentation_tpu_torch.models.deformable_attention import DeformableAttention
from dat_segmentation_tpu_torch.utils import profiling
from dat_segmentation_tpu_torch.utils.profiling import count, recorded, span, trace
from torch_port_helpers import small_fpn, small_upernet


@pytest.fixture(scope="module", autouse=True)
def _profiler_started():
    """kineto's first session in a process takes about 2 s to start."""
    with profile():
        pass


@pytest.fixture(autouse=True)
def _untraced_before(_profiler_started):
    """Each test starts as after an untraced run of the port: a span with
    the profiler off, so that the next session starts the recorder empty."""
    with span("t.untraced"):
        pass


def by_name(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_span_is_the_shared_noop_without_a_session():
    before = recorded()
    first, second = span("t.off"), span("t.off.other")
    assert first is second is profiling._NOOP
    with first:
        count("t.off.counter", 3)
    after = recorded()
    assert after == before
    assert not by_name(after, "t.off") and ("t.off.counter", None) not in after.counts


def test_spans_match_the_profilers_events_one_to_one():
    """Each span is one profiler range of its name, nested alike, and its
    duration is the range's: the recorder runs on the profiler's clock."""
    with profile() as prof:
        for _ in range(3):
            with span("t.outer"):
                time.sleep(0.002)
                with span("t.inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                    time.sleep(0.003)
    rec = recorded()
    events = [e for e in prof.events() if e.name.startswith("t.")]
    assert len(events) == len(rec.spans) == 6
    names = {s.id: s.name for s in rec.spans}
    for name in ("t.outer", "t.inner"):
        ours = sorted(by_name(rec, name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)
        assert len(ours) == len(theirs) == 3
        for s, e in zip(ours, theirs):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith("t."):
                parent = parent.cpu_parent
            assert (names[s.parent] if s.parent is not None else None) == (
                parent.name if parent is not None else None)
            ours_us, theirs_us = s.inclusive_ns / 1e3, e.time_range.elapsed_us()
            assert abs(ours_us - theirs_us) <= max(0.1 * theirs_us, 50.0), (name, ours_us,
                                                                          theirs_us)


def test_nesting_is_per_thread():
    """A span on another thread, opened inside one of this thread's, is a
    root of its own thread (the autograd engine's backward thread)."""
    def work():
        with span("t.thread"):
            with span("t.thread.inner"):
                pass

    with profile():
        with span("t.main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    rec = recorded()
    (main,), (other,), (inner,) = (by_name(rec, n) for n in ("t.main", "t.thread",
                                                             "t.thread.inner"))
    assert main.parent is None and main.root == main.id
    assert other.parent is None and other.root == other.id
    assert inner.parent == other.id and inner.root == other.id


def test_threads_that_start_together_lose_no_span():
    """More threads than cores open spans and counts at a session's start
    with the interpreter switching often: the recorder empties once and
    keeps every span and count."""
    threads, rounds = 16, 50
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=10)
        for _ in range(rounds):
            with span("t.stress"):
                with span("t.stress.inner"):
                    count("t.stress.counter")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    rec = recorded()
    assert len(by_name(rec, "t.stress")) == len(by_name(rec, "t.stress.inner")) == threads * rounds
    assert all(s.parent is None for s in by_name(rec, "t.stress"))
    assert sum(rec.counts.values()) == threads * rounds


def test_self_times_partition_the_inclusive_time():
    with profile():
        with span("t.root"):
            with span("t.a"):
                time.sleep(0.001)
                with span("t.a.a"):
                    time.sleep(0.001)
            time.sleep(0.001)
            with span("t.b"):
                time.sleep(0.001)
    rec = recorded()
    (root,) = by_name(rec, "t.root")
    assert sum(s.self_ns for s in rec.spans if s.root == root.id) == root.inclusive_ns
    (a,), (aa,) = by_name(rec, "t.a"), by_name(rec, "t.a.a")
    assert a.self_ns == a.inclusive_ns - aa.inclusive_ns and aa.self_ns == aa.inclusive_ns
    assert root.self_ns >= 1_000_000


@pytest.mark.parametrize("exact", [False, True], ids=["plain", "valid_hw"])
def test_forward_batch_records_each_layer(exact):
    """One ``dat.serve``, ``dat.backbone`` and ``dat.heads`` a request and a
    ``dat.attention`` a 'D' block, partitioning the request; the composite
    route counted under the request: none plain, every 'D' block exact."""
    torch.manual_seed(0)
    model = build_model(small_fpn(get_config), device="cpu")
    blocks = sum(isinstance(m, DeformableAttention) for m in model.modules())
    assert blocks == 4
    server = SegInferencer(model, num_classes=8, compute_dtype=torch.float32, device="cpu")
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    valid = np.array([[64, 64], [49, 57]], np.int32) if exact else None
    server.forward_batch(x, valid)  # with the profiler off: nothing recorded
    with profile():
        server.forward_batch(x, valid)
    rec = recorded()
    (serve,) = by_name(rec, "dat.serve")
    (backbone,), (heads,) = by_name(rec, "dat.backbone"), by_name(rec, "dat.heads")
    attention = by_name(rec, "dat.attention")
    assert len(attention) == blocks and len(rec.spans) == blocks + 3
    assert serve.parent is None and backbone.parent == heads.parent == serve.id
    assert all(s.parent == backbone.id and s.root == serve.id for s in attention)
    assert backbone.self_ns == backbone.inclusive_ns - sum(s.inclusive_ns for s in attention)
    assert (serve.self_ns + backbone.self_ns + sum(s.inclusive_ns for s in attention)
            + heads.inclusive_ns) == serve.inclusive_ns
    assert rec.counts.get(("attn.composite", serve.id), 0) == (blocks if exact else 0)


def test_train_step_records_its_three_parts():
    cfg = get_config("upn_tiny_160k_dp03_lr6")
    torch.manual_seed(0)
    model = build_model(small_upernet(get_config), device="cpu")
    state = create_train_state(model, cfg)
    step = make_train_step(model, num_classes=8, compute_dtype=torch.float32)
    rng = np.random.RandomState(3)
    batch = {"image": rng.randn(2, 64, 64, 3).astype(np.float32),
             "label": rng.randint(0, 8, (2, 64, 64))}
    with profile():
        step(state, batch)
    rec = recorded()
    (root,) = by_name(rec, "dat.step")
    parts = [by_name(rec, f"dat.step.{p}") for p in ("forward", "backward", "update")]
    assert all(len(p) == 1 and p[0].parent == root.id for p in parts)
    forward = parts[0][0]
    (backbone,), (heads,) = by_name(rec, "dat.backbone"), by_name(rec, "dat.heads")
    assert backbone.parent == heads.parent == forward.id
    assert sum(p[0].inclusive_ns for p in parts) <= root.inclusive_ns
    assert not rec.counts


def test_a_tally_takes_its_counts_whether_or_not_a_session_is_active():
    """``tally()`` collects the counts of its body, off or under a session,
    and keeps them from the session's record (a CUDA graph's capture)."""
    with profiling.tally() as off:
        count("t.tally", 2)
    assert off == {"t.tally": 2}
    with profile():
        with span("t.root"):
            count("t.kept")
            with profiling.tally() as on:
                count("t.tally", 3)
                count("t.tally")
            count("t.kept")
    rec = recorded()
    (root,) = by_name(rec, "t.root")
    assert on == {"t.tally": 4}
    assert rec.counts == {("t.kept", root.id): 2}


def test_a_new_session_starts_the_recorder_empty():
    torch.manual_seed(0)
    server = SegInferencer(build_model(small_fpn(get_config), device="cpu"), num_classes=8,
                           compute_dtype=torch.float32, device="cpu")
    x = np.zeros((1, 64, 64, 3), np.float32)
    with profile():
        with span("t.first"):
            count("t.counter", 2)
    assert by_name(recorded(), "t.first")
    server.forward_batch(x)  # the port, with the profiler off
    assert by_name(recorded(), "t.first")  # kept until a session starts
    with profile():
        with span("t.second"):
            count("t.counter")
    rec = recorded()
    assert [s.name for s in rec.spans] == ["t.second"]
    assert rec.counts == {("t.counter", rec.spans[0].id): 1}


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        with span("the_matmul"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "the_matmul" for e in events)
    assert any(e.key == "the_matmul" for e in prof.key_averages())
    assert [s.name for s in recorded().spans] == ["the_matmul"]
