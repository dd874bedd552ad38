"""Closed-loop serving through ``SegInferencer.forward_batch``.

One client, one request in flight: a request is a batch of normalised
images from a pool made at set-up from the seed and kept on the card, and it
ends when its stride-4 logits are complete on the card (synchronised). The
window runs ``--seconds``; each request is timed from its dispatch to its
logits. With ``true_h``/``true_w`` in the traffic each image is a true size
zero-padded to ``shape`` and the call passes ``valid_hw`` (exact padded
inference); the sizes are one fixed set for every seed, assigned in the
seed's order.

After the window a sample of the finished requests, drawn from the seed, is
compared with the reference (float32, no TF32) run on the same inputs, image
by image at its true size: ``logit_rel_l2``.

Traffic keys: ``batch``, ``shape`` [H, W], ``pool`` (distinct batches),
``warmup`` (requests before the window), ``check_requests`` (sampled),
``check_chunk`` (images a reference forward), ``trace_seconds`` (the traced
window), and optionally ``true_h``/``true_w`` [lo, hi].
"""

from __future__ import annotations

import gc
import random
import statistics
import time

import numpy as np
import torch

from bench_port.check import exact_float32, reference_model, reference_shapes, rel_l2
from bench_port.harness import Outcome, memory_peak, release, sync
from bench_port.trace import run_traced
from bench_port.weights import make_weights, normal_images


def true_sizes(tr: dict, n: int, gen: torch.Generator, device) -> np.ndarray:
    """(n, 2) true sizes: ``n`` evenly spread heights and widths over the
    traffic's ranges, paired and ordered by the seed's permutations."""
    hs = np.round(np.linspace(tr["true_h"][0], tr["true_h"][1], n)).astype(np.int64)
    ws = np.round(np.linspace(tr["true_w"][0], tr["true_w"][1], n)).astype(np.int64)
    ph = torch.randperm(n, generator=gen, device=device).cpu().numpy()
    pw = torch.randperm(n, generator=gen, device=device).cpu().numpy()
    return np.stack([hs[ph], ws[pw]], 1)


def make_pool(cell, device):
    """The pool's images (pool·batch, H, W, 3) and true sizes (or None)."""
    tr = cell.traffic
    n = tr["pool"] * tr["batch"]
    gen = torch.Generator(device=device).manual_seed(cell.seed_for("inputs"))
    images = normal_images(n, tr["shape"][0], tr["shape"][1], gen, device)
    if "true_h" not in tr:
        return images, None
    sizes = true_sizes(tr, n, gen, device)
    rows = torch.arange(tr["shape"][0], device=device)
    cols = torch.arange(tr["shape"][1], device=device)
    sz = torch.as_tensor(sizes, device=device)
    inside = ((rows[None, :, None] < sz[:, 0, None, None])
              & (cols[None, None, :] < sz[:, 1, None, None]))
    return images * inside[..., None], sizes


def build_server(cell, device):
    """The program's ``SegInferencer`` over the configuration's model with
    the seed's weights (bf16, as served)."""
    from dat_segmentation_tpu_torch.eval.inference import SegInferencer
    from dat_segmentation_tpu_torch.models.builder import build_model

    cfg = cell.program_config()
    with torch.device("meta"):
        model = build_model(cfg.model, device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(make_weights(reference_shapes(cell.config), cell.seed_for("weights"),
                                       device, torch.bfloat16))
    server = SegInferencer(model, num_classes=cfg.model.num_classes,
                           compute_dtype=torch.bfloat16, device=device)
    del model
    return server


def reference_gap(cell, device, requests, images, sizes, model=None) -> float:
    """The largest ``rel_l2`` over the images of ``requests`` ((pool index,
    logits) pairs) against the reference (``model``, else float32)."""
    tr = cell.traffic
    B, chunk = tr["batch"], tr["check_chunk"]
    if model is None:
        exact_float32()
        model = reference_model(cell.config, device, cell.seed_for("weights"), torch.bfloat16)
    model.eval()
    worst = 0.0
    with torch.no_grad():
        for p, out in requests:
            x = images[p * B:(p + 1) * B]
            if sizes is None:
                for j in range(0, B, chunk):
                    ref = model(x[j:j + chunk], upsample=False)
                    worst = max([worst] + [rel_l2(o, r) for o, r in zip(out[j:j + chunk], ref)])
                continue
            for j in range(B):
                h, w = (int(v) for v in sizes[p * B + j])
                ref = model(x[j:j + 1, :h, :w], upsample=False)[0]
                worst = max(worst, rel_l2(out[j, :ref.shape[0], :ref.shape[1]], ref))
    return worst


def run(cell) -> Outcome:
    tr, device = cell.traffic, cell.device
    B, P = tr["batch"], tr["pool"]
    cell.mark("build")
    server = build_server(cell, device)
    cell.mark("pool")
    images, sizes = make_pool(cell, device)
    valid = None if sizes is None else sizes.reshape(P, B, 2)

    def call(i):
        p = i % P
        x = images[p * B:(p + 1) * B]
        return server.forward_batch(x) if valid is None else server.forward_batch(x, valid[p])

    cell.mark("warmup")
    for i in range(tr["warmup"]):
        call(i)
    sync(device)
    gc.collect()
    gc.freeze()  # what set-up left is not scanned again by the window's collections
    cell.mark("window")
    setup_s = time.perf_counter() - cell.t_start

    pick = random.Random(cell.seed_for("sample"))
    kept, latencies, dispatch = [], [], []
    k = tr["check_requests"]

    def loop(seconds):
        t0 = time.perf_counter()
        i, t1 = 0, t0
        while t1 - t0 < seconds:
            with torch.profiler.record_function("bench.request"):
                ts = time.perf_counter()
                out = call(i)
                dispatch.append(time.perf_counter() - ts)
                sync(device)
            t1 = time.perf_counter()
            latencies.append(t1 - ts)
            if len(kept) < k:  # a reservoir sample of the finished requests
                kept.append((i % P, out))
            elif pick.random() < k / (i + 1):
                kept[pick.randrange(k)] = (i % P, out)
            i += 1
        return t1 - t0

    trace = None
    if cell.trace:
        trace = run_traced(lambda: loop(tr["trace_seconds"]), lambda: sync(device))
    else:
        window = loop(cell.seconds)
    n = len(latencies)
    peak = memory_peak(device)
    del server
    release(device)
    cell.mark("check")
    t_check = time.perf_counter()
    gap = reference_gap(cell, device, kept, images, sizes)
    t_check = time.perf_counter() - t_check

    e2e, run_info = {}, {"units": n, "batch": B, "dispatch_s": dispatch}
    if cell.trace:
        from bench_port.metrics.yardstick import count_work

        work = count_work(cell.config["train_config"]["model"], 1, tr["shape"], False)
        run_info.update(flops=work["flops"] * B, calls=work["calls"], lse=False)
    else:
        e2e = {"serve_img_per_s": n * B / window,
               "serve_p95_ms": statistics.quantiles(latencies, n=20)[18] * 1e3,
               "setup_s": setup_s}
    return Outcome(attempted=n, failed=0, end_to_end=e2e,
                   checks={"logit_rel_l2": gap, "check_s": t_check}, memory_peak=peak,
                   run=run_info, trace=trace)
