#!/usr/bin/env python3
"""Time the flagship's serving artifact against its live forward on one
CUDA card, to compare two trees of the port in turns.

    PYTHONPATH=<tree> python3 dat_segmentation_tpu_torch/tools/artifact_time.py

prints one JSON line. ``fpn_tiny_80k_dp04_lr2`` (random weights from seed
0) is exported at batch 16, 512x512, bf16, with ``export_segmentor`` and
``save_artifact`` into a temporary directory and loaded with
``ServingModel``; its entry and ``SegInferencer.forward_batch`` of the same
model run on 16 images from seed 0, in turns (artifact, live, live,
artifact, three times), each turn ``ITERS`` calls timed with CUDA events
after one warm-up call (``ms``, one value a turn). Uses only what every
tree's ``serving/`` has since the export slice. Run it for two trees in
turns (a, b, b, a) in one call: host time varies between machines and over
a call. It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ITERS, ROUNDS = 5, 3


def timed(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    if not torch.cuda.is_available():
        print("artifact_time: no CUDA device", file=sys.stderr)
        return 1
    import dat_segmentation_tpu_torch as port
    from dat_segmentation_tpu_torch.serving import ServingModel, export_segmentor, save_artifact

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = port.get_config("fpn_tiny_80k_dp04_lr2").model
    torch.manual_seed(0)
    model = port.build_model(cfg, device=dev)
    program = export_segmentor(cfg, model.state_dict(), batch=16, input_size=(512, 512),
                               device=dev)
    x = torch.tensor(np.random.RandomState(0).randn(16, 512, 512, 3), dtype=torch.float32,
                     device=dev)
    with tempfile.TemporaryDirectory() as d:
        srv = ServingModel.load(save_artifact(d, {"e": program}))
        live = port.SegInferencer(model, num_classes=cfg.num_classes, device=dev)
        fns = {"artifact": lambda: srv("e", x), "live": lambda: live.forward_batch(x)}
        ms = {"artifact": [], "live": []}
        for name in ("artifact", "live", "live", "artifact") * ROUNDS:
            ms[name].append(timed(fns[name]))
    print(json.dumps({"package": port.__file__, "card": card, "batch": 16, "dtype": "bfloat16",
                      "median_ms": {k: statistics.median(v) for k, v in ms.items()}, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
