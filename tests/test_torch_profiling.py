"""The port's ``utils/profiling.py`` on the CPU, as the JAX package's
``tests/test_utils.py`` holds its own: the throughput meter, the timer,
the operation count (also of the ``dat::`` ops by their formulas) and the
trace file."""

import json

import torch

from dat_segmentation_tpu_torch.ops import deform_attn as da
from dat_segmentation_tpu_torch.ops import x_block as xb
from dat_segmentation_tpu_torch.utils.profiling import (Throughput, annotate, benchmark,
                                                        compiled_stats, trace)

torch.set_num_threads(2)


def test_throughput_meter():
    tp = Throughput(warmup=1)
    tp.step(4)
    assert tp.rate is None
    tp.step(4)
    tp.step(4)
    assert tp.rate is not None and tp.rate > 0


def test_benchmark_and_compiled_stats():
    """A 64x64 matmul: 2·64³ operations, its argument's and result's
    bytes; no allocator peak for CPU tensors."""
    def f(x):
        return x @ x

    x = torch.ones(64, 64)
    assert benchmark(f, x, iters=3, warmup=1) > 0
    stats = compiled_stats(f, x)
    assert stats == {"flops": 2.0 * 64 ** 3, "argument_bytes": 64 * 64 * 4,
                     "output_bytes": 64 * 64 * 4}


def test_compiled_stats_counts_the_kernels_ops():
    """Without grad, K1's op counts 4·BG·H·W·Ns·Cg (PERF.md's bound) and
    K3's op its fc1/fc2 and depthwise products."""
    BG, H, W, Cg, Ns = 2, 8, 8, 32, 16
    q, k = torch.randn(BG, H, W, Cg), torch.randn(BG, Ns, Cg)
    pos, table = torch.rand(BG, Ns, 2) * 2 - 1, torch.randn(1, 1, 15, 15)
    with torch.no_grad():
        stats = compiled_stats(lambda *a: da.deform_attn(*a, n_groups=1, scale=0.17),
                               q, k, k, pos, table)
    assert stats["flops"] == 4 * BG * H * W * Ns * Cg
    B, C, E = 1, 16, 64
    x = torch.randn(B, H, W, C)
    p = dict(w3=torch.randn(C, 1, 3, 3), b3=torch.randn(C), w7=torch.randn(C, 1, 7, 7),
             b7=torch.randn(C), g=torch.ones(C), be=torch.zeros(C), wf1=torch.randn(E, C),
             bf1=torch.zeros(E), wd=torch.randn(E, 1, 3, 3), bd=torch.zeros(E),
             wf2=torch.randn(C, E), bf2=torch.zeros(C))
    with torch.no_grad():
        stats = compiled_stats(lambda t: xb.x_block_fwd(t, *p.values(), with_lpu=True), x)
    n = B * H * W
    assert stats["flops"] == 2 * n * 2 * C * E + 2 * n * (C * (9 + 49) + 9 * E)


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        with annotate("the_matmul"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "the_matmul" for e in events)
    assert any(e.key == "the_matmul" for e in prof.key_averages())
