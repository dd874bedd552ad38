#!/usr/bin/env python3
"""Time the fused X-block kernel K3 per (stage, mode) of the flagship, to
compare two trees of the port in one call.

    PYTHONPATH=<tree> python3 dat_segmentation_tpu_torch/tools/k3_time.py

prints one JSON line: for each (stage, mode) that the flagship
``fpn_tiny_80k_dp04_lr2`` runs K3 in at 512x512 (mode 'X': an 'X' block,
LPU + 7x7 window + ConvMLP; 'mlp': the ConvMLP half of a 'D' block), K3's
ms a launch (``x_block_fwd``, bf16, batch 16, CUDA events over ``ITERS``
launches after warm-up), the unfused stock-op chain's ms on the same
inputs (the yardstick ``chip_smoke.py`` also times), the tile and its
shared memory, and the totals a forward (each row times its launches a
forward). It uses only what every tree's ``ops/x_block.py`` has, so the
same script times a parent tree: run parent, change, change, parent as
separate processes. It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

PRESET = "fpn_tiny_80k_dp04_lr2"
IMG, BATCH, ITERS = 512, 16, 20
PARAMS = ("w3", "b3", "w7", "b7", "g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")


def xb_inputs(dev, dtype, B, H, W, C, k=7, mode="lpu", seed=0, **_):
    """x and the port's parameter tensors of one fused X block (mode 'lpu',
    'x' without the LPU, or 'mlp'), weights at 1/sqrt(fan-in), from a seed."""
    rng = np.random.RandomState(seed)
    E = 4 * C

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.randn(*shape) * scale + shift, dtype=torch.float32,
                            device=dev).to(dtype)

    p = dict(w3=None, b3=None, w7=None, b7=None)
    if mode == "lpu":
        p.update(w3=t(C, 1, 3, 3, scale=1 / 3), b3=t(C, scale=0.1))
    if mode != "mlp":
        p.update(w7=t(C, 1, k, k, scale=1 / k), b7=t(C, scale=0.1))
    p.update(g=t(C, scale=0.1, shift=1.0), be=t(C, scale=0.1), wf1=t(E, C, scale=C ** -0.5),
             bf1=t(E, scale=0.1), wd=t(E, 1, 3, 3, scale=1 / 3), bd=t(E, scale=0.1),
             wf2=t(C, E, scale=E ** -0.5), bf2=t(C, scale=0.1))
    return t(B, H, W, C), p


def stock_chain(x, p, mode):
    """K3's yardstick: the unfused chain the model runs without it (the
    port's Conv2d, LayerNorm2d and ConvMlp modules: cuDNN depthwise convs on
    channels-last views, LayerNorm, cuBLAS linears with their bias, GELU)."""
    def dw(v, w, b):
        return F.conv2d(v.permute(0, 3, 1, 2), w, b, padding=w.shape[-1] // 2,
                        groups=v.shape[-1]).permute(0, 2, 3, 1)

    if mode == "lpu":
        x = x + dw(x, p["w3"], p["b3"])
    y = x if mode == "mlp" else dw(x, p["w7"], p["b7"])
    y = F.layer_norm(y, (y.shape[-1],), p["g"], p["be"])
    h = F.linear(y, p["wf1"], p["bf1"])
    h = F.gelu(h + dw(h, p["wd"], p["bd"]))
    return F.linear(h, p["wf2"], p["bf2"])


def flagship_rows(bb, img=IMG, batch=BATCH):
    """(stage, mode, x shape, window, launches a forward) of each K3 row."""
    rows = []
    for i, spec in enumerate(bb.stage_spec):
        H = img // bb.patch_size // 2 ** i
        for mode, k, n in (("X", bb.window_sizes[i], spec.count("X")), ("mlp", 1, spec.count("D"))):
            if n:
                rows.append(dict(stage=i, mode=mode, x=[batch, H, H, bb.dims[i]], k=k,
                                 launches_per_forward=n))
    return rows


def timed(fn, iters=ITERS, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_time: no CUDA device", file=sys.stderr)
        return 1
    import dat_segmentation_tpu_torch as port
    from dat_segmentation_tpu_torch.ops import x_block as xb

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rows = flagship_rows(port.get_config(PRESET).model.backbone)
    tot = {"ms": 0.0, "chain_ms": 0.0}
    for row in rows:
        B, H, W, C = row["x"]
        mode = "lpu" if row["mode"] == "X" else "mlp"
        kmode = xb.MODE_X_LPU if mode == "lpu" else xb.MODE_MLP
        x, prm = xb_inputs(dev, torch.bfloat16, B, H, W, C, k=row["k"], mode=mode)
        args = [prm[n] for n in PARAMS]
        with torch.inference_mode():
            row["ms"] = timed(lambda: xb.x_block_fwd(x, *args, with_lpu=mode == "lpu"))
            row["chain_ms"] = timed(lambda: stock_chain(x, prm, mode))
        row["tile"] = [xb.tile_rows(torch.bfloat16, C, kmode, row["k"]), 8]
        row["smem_bytes"] = xb.smem_bytes(torch.bfloat16, C, kmode, row["k"])
        for key in tot:
            tot[key] += row[key] * row["launches_per_forward"]
        del x, prm, args
    print(json.dumps({"tool": "k3_time", "card": card, "tree": port.__file__,
                      "dtype": "bfloat16", "batch": BATCH, "rows": rows,
                      "per_forward": tot}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
