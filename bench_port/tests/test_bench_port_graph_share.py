"""``graph_share.serve``: the share of a window's requests that carry the
program's ``serve.graph`` counter, read from the recorder, and reported at 0
by a traced small serving cell on the CPU, where no forward is captured."""

import time

from torch.profiler import profile

from conftest import tiny_files

from bench_port import harness
from dat_segmentation_tpu_torch.utils import profiling

READER = harness.HERE / "metrics" / "graph_share.serve.py"


def test_the_share_counts_the_requests_that_carry_the_counter():
    with profile():
        for replayed in (False, True, True, True):
            with profiling.span("dat.serve"):
                if replayed:
                    profiling.count("serve.graph")
        with profiling.span("bench.other"):
            profiling.count("serve.graph")
    assert harness.load_file(READER).read(None) == 75.0


def test_a_traced_cpu_cell_reports_no_replay():
    cell = harness.load_cell("fpn_tiny.serve.b16", 2 ** 31 + 11, 0.3, True, "cpu",
                             time.perf_counter(), files=tiny_files("tiny_fpn", "serve", "serve"))
    out = harness.run_cell(cell)[0]
    assert out["correct"], out["checks"]
    assert out["metrics"]["graph_share.serve"] == {"value": 0.0, "unit": "%"}
