#!/usr/bin/env python3
"""Time the port's bf16 train step and serving forward on one CUDA card,
to compare two trees of the port in turns.

    PYTHONPATH=<tree> python3 dat_segmentation_tpu_torch/tools/step_time.py

prints one JSON line. The step is ``make_train_step`` on DAT-T++ UperNet +
FCN aux (``upn_tiny_160k_dp03_lr6`` as it is, warm-up 0; random weights
from seed 0) at batch 16, 512x512, bf16, on one synthetic batch from seed
5; the forward is ``SegInferencer.forward_batch`` of the flagship
``fpn_tiny_80k_dp04_lr2`` (seed 0) on 16 images from seed 3. Each is
timed with the host clock around ``REPEATS`` runs of ``ITERS`` calls
ending in a synchronize, after warm-up (``wall_ms``, one value a run),
and its device time is the sum of the kernels ``torch.profiler`` records
over ``PROFILE_ITERS`` calls (``device_ms``). Run it for two trees in
turns (a, b, a, b, ...) in one call: host time varies between machines
and over a call. It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

ITERS, REPEATS, PROFILE_ITERS = 5, 3, 2


def wall_ms(fn) -> list:
    runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / ITERS)
    return runs


def device_ms(fn) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_ITERS):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total_us += getattr(e, "self_device_time_total", 0.0)
    return total_us / 1e3 / PROFILE_ITERS


def main() -> int:
    if not torch.cuda.is_available():
        print("step_time: no CUDA device", file=sys.stderr)
        return 1
    from dataclasses import replace

    import dat_segmentation_tpu_torch as port

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    cfg = port.get_config("upn_tiny_160k_dp03_lr6")
    cfg = replace(cfg, schedule=replace(cfg.schedule, warmup_iters=0))
    mc = cfg.model
    torch.manual_seed(0)
    model = port.build_model(mc, device=dev)
    state = port.create_train_state(model, cfg)
    step = port.make_train_step(model, aux_weight=mc.aux_loss_weight,
                                ignore_index=cfg.data.ignore_index,
                                num_classes=mc.num_classes, compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(5)
    label = rng.randint(0, mc.num_classes, (16, 512, 512))
    label[rng.rand(16, 512, 512) < 0.05] = 255
    batch = {"image": torch.tensor(rng.randn(16, 512, 512, 3), dtype=torch.float32, device=dev),
             "label": torch.tensor(label, dtype=torch.long, device=dev)}
    for _ in range(2):
        step(state, batch)
    step_wall = wall_ms(lambda: step(state, batch))
    step_device = device_ms(lambda: step(state, batch))
    del model, state, step, batch
    torch.cuda.empty_cache()

    fcfg = port.get_config("fpn_tiny_80k_dp04_lr2").model
    torch.manual_seed(0)
    server = port.SegInferencer(port.build_model(fcfg, device=dev),
                                num_classes=fcfg.num_classes, device=dev)
    x16 = torch.tensor(np.random.RandomState(3).randn(16, 512, 512, 3), dtype=torch.bfloat16,
                       device=dev)
    for _ in range(2):
        server.forward_batch(x16)
    fwd_wall = wall_ms(lambda: server.forward_batch(x16))
    fwd_device = device_ms(lambda: server.forward_batch(x16))
    print(json.dumps({"package": port.__file__, "card": card, "batch": 16, "dtype": "bfloat16",
                      "step_wall_ms": step_wall, "step_device_ms": step_device,
                      "forward_wall_ms": fwd_wall, "forward_device_ms": fwd_device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
