"""The program's spans and counter, read by the per-layer metrics of
``metrics/spans.py``: traced runs of small cells on the CPU report each
metric in its cells, the composite counter reads the route, the request's
spans partition it, and a run leaves the harness's files as they were."""

import time

import pytest

from conftest import ROOT, tiny_files

from bench_port import harness
from dat_segmentation_tpu_torch.utils import profiling

SERVE = {"serve_host_ms.serve", "backbone_host_ms.serve", "attention_host_ms.serve",
         "heads_host_ms.serve", "composite_calls.serve"}
TRAIN = {"forward_host_ms.train", "backward_host_ms.train", "update_host_ms.train"}
CELLS = {"serve": ("fpn_tiny.serve.b16", "tiny_fpn", "serve", "serve"),
         "exact": ("fpn_tiny.serve.exact_b16", "tiny_fpn", "serve_exact", "serve"),
         "train": ("upn_tiny.train.b16", "tiny_upn", "train", "train")}


def harness_files():
    """What ``test_bench_port_extend.py`` snapshots: the harness but its tests."""
    return {p: p.read_bytes() for p in (ROOT / "bench_port").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and "tests" not in p.parts}


@pytest.fixture(scope="module")
def runs():
    """Each small cell traced once: its result and what the recorder held."""
    before, out = harness_files(), {}
    for kind, (workload, conf, traffic, limits) in CELLS.items():
        cell = harness.load_cell(workload, 2 ** 31 + 11, 0.3, True, "cpu", time.perf_counter(),
                                 files=tiny_files(conf, traffic, limits))
        out[kind] = (harness.run_cell(cell)[0], profiling.recorded(), cell)
    assert harness_files() == before
    return out


def d_blocks(cell):
    model = cell.config["train_config"]["model"]["backbone"]
    return sum(spec[:depth].count("D") for spec, depth in zip(model["stage_spec"],
                                                               model["depths"]))


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_metrics_report_in_their_cells(runs, kind):
    out, rec, cell = runs[kind]
    assert out["correct"], out["checks"]
    want = TRAIN if kind == "train" else SERVE
    assert want <= set(out["metrics"]) and not (SERVE | TRAIN) - want & set(out["metrics"])
    assert all(out["metrics"][n]["value"] >= 0 for n in want)
    if kind == "train":
        steps = [s for s in rec.spans if s.name == "dat.step"]
        assert len(steps) == out["attempted"]
    else:
        assert 0 < out["metrics"]["serve_host_ms.serve"]["value"]


@pytest.mark.parametrize("kind", ["serve", "exact"])
def test_composite_calls_read_the_route(runs, kind):
    out, _, cell = runs[kind]
    blocks = d_blocks(cell)
    assert blocks == 5
    assert out["metrics"]["composite_calls.serve"]["value"] == (blocks if kind == "exact" else 0)


@pytest.mark.parametrize("kind", ["serve", "exact"])
def test_each_request_is_partitioned_by_its_spans(runs, kind):
    out, rec, cell = runs[kind]
    roots = {s.id: s for s in rec.spans if s.name == "dat.serve"}
    assert len(roots) == out["attempted"]
    parts = {r: 0 for r in roots}
    for s in rec.spans:
        if s.name == "dat.backbone":
            parts[s.root] += s.self_ns
        elif s.name in ("dat.attention", "dat.heads"):
            parts[s.root] += s.inclusive_ns
    for r, root in roots.items():
        assert root.self_ns + parts[r] == root.inclusive_ns
        assert sum(s.name == "dat.attention" for s in rec.spans if s.root == r) == d_blocks(cell)
