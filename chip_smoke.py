#!/usr/bin/env python3
"""Drive the PyTorch port's serving forward and training step on one CUDA
card and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a), the
CUDA toolkit's ``nvcc`` and the repository; it exits non-zero at once
without a CUDA device, and never runs on the CPU instead. Phases, one JSON
line each:

1. device: the card's name and power limit (as nvidia-smi gives them),
   the torch, CUDA and nvcc versions.
2. build: every CUDA source of the port, built at once (one nvcc each),
   with the registers and spills ptxas reports.
3. kernel_check: each kernel against its plain PyTorch version on the card
   at the shapes the main paths give it, in float32 and bf16 (K2: all
   five gradients).
4. model: the full-width, full-depth DAT-T++ SemanticFPN (preset
   fpn_tiny_80k_dp04_lr2, 26 blocks) at 512x512 with random weights from
   a fixed seed, in float32 with TF32 off: the kernel path on the card
   against the plain path (the same model on the CPU).
5. serve: the main path. ``SegInferencer`` answers requests in bf16
   (batches of 512x512 images, then one whole image); each kernel's
   launch count, set to 0 just before, must show every kernel ran.
6. times: K1 per stage (CUDA events, after warm-up) beside its plain
   version, one PyTorch library call computing the same function (the
   yardstick, used nowhere in the port) and the least time the card could
   take; the forward at batch 16 in bf16 (ms/img, img/s, peak memory) and
   a profile of where its device time goes.
7. train_model: the full-width, full-depth DAT-T++ UperNet with its FCN
   auxiliary head (preset upn_tiny_160k_dp03_lr6, 150 classes) from a
   fixed seed takes one float32 train step (TF32 off, drop path and
   dropout 0) on a 2x512x512 batch: the kernel path on the card against a
   copy of the same model on the CPU (loss, gradients, BN statistics, IoU
   counts).
8. train: the main path of the training slice. ``make_train_step`` on the
   preset as it is (drop path 0.3, dropout 0.1; warm-up 0 so the learning
   rate is not 6e-11) in bf16 at batch 16, a few steps on one synthetic
   batch; the launch counts, set to 0 just before, must show 14 K1 and 14
   K2 launches a step.
9. train times: K2 per stage as K1 above (the yardstick is the backward
   of one ``scaled_dot_product_attention`` with the bias prebuilt), the
   train step at batch 16 (ms, img/s, peak memory) and a profile of its
   device time.

Then a ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import re
import subprocess
import sys
import time

SEED = 0
PRESET = "fpn_tiny_80k_dp04_lr2"
TRAIN_PRESET = "upn_tiny_160k_dp03_lr6"
IMG = 512
SERVE_BATCH, SERVE_REQUESTS = 4, 4
TIME_BATCH = 16
TRAIN_BATCH, TRAIN_STEPS, TIME_STEPS = 16, 10, 5

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# float32: the kernel sums in another order than the plain version and
# uses the fast exp; nothing else differs.
TOL_F32 = 1e-4
# bf16: both round the output to bf16 (one ulp is 2^-8 relative) and the
# plain version also rounds P to bf16 before P·V.
TOL_BF16 = 1e-2
# Full model, float32, TF32 off: cuDNN and the CPU sum convolutions in
# other orders, the kernel as above, over 26 blocks and the FPN.
TOL_MODEL = 1e-3
# K2, each gradient's max |error| over its max |value|: float32 atomics sum
# dk, dv, dpos and dtable in an order that changes from run to run; in
# bf16 dq, dk, dv are rounded to bf16 and the plain version rounds P.
TOL_BWD_F32 = 1e-4
TOL_BWD_BF16 = 2e-2
# One float32 train step of the full UperNet, card against CPU: the loss
# (relative), all gradients (||g_card - g_cpu|| / ||g_cpu||), each
# parameter's gradient (||dg_p|| <= TOL_GRAD_PARAM ||g_p|| + 1e-6 ||g||:
# some gradients, e.g. proj_k.bias, are 0 in exact arithmetic and only
# float32 noise on both sides) and the BN running statistics (absolute).
# The gradient is not continuous in the activations: a ReLU input or a
# bilinear sample position within float32 rounding of its switch point
# goes either way, and each such flip moves a weight gradient by one
# position's share. On the CPU alone, the same step on the image
# perturbed by 1e-6 relative moved all gradients by 8.7e-4 (PERF.md,
# §6): the card's 1.1e-3 sits on that floor, TOL_GRAD at about 3x it.
TOL_TRAIN_LOSS = 1e-5
TOL_GRAD = 3e-3
TOL_GRAD_PARAM = 2e-2
TOL_BN = 1e-4

KERNELS = [
    {
        "name": "deform_attn_fwd",
        "route": "cuda",
        "source": "dat_segmentation_tpu_torch/csrc/deform_attn_fwd.cu",
        "replaces": "dat_segmentation_tpu/ops/pallas/deform_attn.py:711",
    },
    {
        "name": "deform_attn_bwd",
        "route": "cuda",
        "source": "dat_segmentation_tpu_torch/csrc/deform_attn_bwd.cu",
        "replaces": "dat_segmentation_tpu/ops/pallas/deform_attn.py:1420",
    },
]

GRADS = ("dq", "dk", "dv", "dpos", "dtable")

failures = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        print(f"chip_smoke: FAILED {what}", file=sys.stderr, flush=True)


def nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


T_START = time.perf_counter()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
    from dat_segmentation_tpu_torch.ops import cuda_build
    from dat_segmentation_tpu_torch.ops import deform_attn as da

    card = nvidia_smi_card()
    dev = torch.device("cuda")

    def timed(fn, iters, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    # ---- 1. device ----------------------------------------------------------
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nvcc": nvcc[-1] if nvcc else None, "triton": has_triton})

    # ---- 2. build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    sources = [k["source"].rsplit("/", 1)[1] for k in KERNELS]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.build, sources))
    build_s = time.perf_counter() - t0
    for src in sources:
        log = cuda_build.build_log(src)
        emit({"phase": "build", "card": card, "source": src, "seconds": build_s,
              "flags": " ".join(cuda_build.NVCC_FLAGS),
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if re.search(r"registers|spill", ln)]})
    emit({"phase": "build", "card": card, "source": da.SOURCE,
          "smem_bytes_stage0": {"float32": da.smem_bytes(torch.float32, 256, 111, 111),
                                "bfloat16": da.smem_bytes(torch.bfloat16, 256, 111, 111)}})
    emit({"phase": "build", "card": card, "source": da.BWD_SOURCE,
          "smem_bytes_stage0": {"float32": da.bwd_smem_bytes(torch.float32, 256, 111, 111),
                                "bfloat16": da.bwd_smem_bytes(torch.bfloat16, 256, 111, 111)},
          "smem_bytes_max_per_block": torch.cuda.get_device_properties(0).shared_memory_per_block_optin})

    # ---- stage geometry of the flagship at 512x512 ---------------------------
    cfg = get_config(PRESET).model
    bb = cfg.backbone
    stages = []
    for i in range(4):
        H = IMG // bb.patch_size // 2 ** i
        ks, st = bb.ksizes[i], bb.strides[i]
        Hk = (H + 2 * (ks // 2 if ks != st else 0) - ks) // st + 1  # the offset conv's output
        q_size = bb.img_size // bb.patch_size // 2 ** i
        stages.append(dict(
            stage=i, g=bb.groups[i], h_g=bb.heads[i] // bb.groups[i],
            Cg=bb.dims[i] // bb.groups[i], H=H, W=H, Ns=Hk * Hk,
            th=2 * q_size - 1, launches_per_forward=bb.stage_spec[i].count("D"),
        ))
    scale = 32 ** -0.5
    emit(x_block_bound(cfg.backbone, stages, card))

    def k1_inputs(B, g, h_g, Cg, H, W, Ns, th, dtype, pos_range=1.0, seed=SEED, **_):
        rng = np.random.RandomState(seed)
        arrs = [rng.randn(B * g, H, W, Cg) * 0.5, rng.randn(B * g, Ns, Cg) * 0.5,
                rng.randn(B * g, Ns, Cg) * 0.5,
                rng.uniform(-pos_range, pos_range, (B * g, Ns, 2)),
                rng.randn(g, h_g, th, th) * 0.1]
        t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]
        return t[0].to(dtype), t[1].to(dtype), t[2].to(dtype), t[3], t[4].to(dtype)

    # ---- 3. kernel_check ----------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [dict(s, B=2, what=f"T++ stage {s['stage']}") for s in stages]
    cases.append(dict(B=2, g=2, h_g=3, Cg=96, H=64, W=64, Ns=256, th=55,
                      what="S++ stage 1 (h_g 3, Cg 96)"))
    cases.append(dict(stages[2], B=2, pos_range=1.2, what="T++ stage 2, pos ~ U(-1.2, 1.2)"))
    cases.append(dict(B=2, g=2, h_g=2, Cg=64, H=32, W=32, Ns=49, th=55, hn=28, wn=28,
                      what="queries padded 28 -> 32 (hn = wn = 28), Ns 49"))
    max_err = 0.0
    for c in cases:
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            q, k, v, pos, table = k1_inputs(dtype=dtype, **c)
            kw = dict(n_groups=c["g"], scale=scale, hn=c.get("hn", 0), wn=c.get("wn", 0))
            with torch.inference_mode():
                got = da.deform_attn(q, k, v, pos, table, **kw)
                ref = da.deform_attn_reference(q, k, v, pos, table, **kw)
                torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            emit({"phase": "kernel_check", "card": card, "kernel": "deform_attn_fwd",
                  "case": c["what"], "dtype": str(dtype).split(".")[1],
                  "q": list(q.shape), "k": list(k.shape), "table": list(table.shape),
                  "max_abs_err": err, "tol": tol})
            check(err <= tol and got.shape == ref.shape,
                  f"kernel_check {c['what']} {dtype}: {err} > {tol}")

    # K2: all five gradients against autograd of the plain version
    max_err_bwd = max_rel_bwd = 0.0
    for c in cases:
        for dtype, tol in ((torch.float32, TOL_BWD_F32), (torch.bfloat16, TOL_BWD_BF16)):
            q, k, v, pos, table = k1_inputs(dtype=dtype, **c)
            dout = torch.tensor(np.random.RandomState(SEED + 9).randn(*q.shape),
                                dtype=torch.float32, device=dev).to(dtype)
            kw = dict(n_groups=c["g"], scale=scale, hn=c.get("hn", 0), wn=c.get("wn", 0))
            got = da.deform_attn_bwd(q, k, v, pos, table, dout, **kw)
            ref = da.deform_attn_bwd_reference(q, k, v, pos, table, dout, **kw)
            torch.cuda.synchronize()
            errs, rel = {}, {}
            for name, a, b in zip(GRADS, got, ref):
                errs[name] = (a.float() - b.float()).abs().max().item()
                rel[name] = errs[name] / max(b.float().abs().max().item(), 1e-12)
            max_err_bwd = max(max_err_bwd, *errs.values())
            max_rel_bwd = max(max_rel_bwd, *rel.values())
            emit({"phase": "kernel_check", "card": card, "kernel": "deform_attn_bwd",
                  "case": c["what"], "dtype": str(dtype).split(".")[1], "q": list(q.shape),
                  "table": list(table.shape), "max_abs_err": errs, "max_rel_err": rel,
                  "tol_rel": tol})
            check(max(rel.values()) <= tol
                  and all(a.shape == b.shape for a, b in zip(got, ref)),
                  f"kernel_check K2 {c['what']} {dtype}: {rel} > {tol}")

    # ---- 4. model: kernel path on the card vs the plain path on the CPU ------
    torch.manual_seed(SEED)
    model = build_model(cfg, device=dev)
    image = torch.tensor(np.random.RandomState(SEED + 1).randn(1, IMG, IMG, 3),
                         dtype=torch.float32)
    da.deform_attn.launches = 0
    with torch.inference_mode():
        gpu_logits = model(image.to(dev)).float()
        torch.cuda.synchronize()
        gpu_launches = da.deform_attn.launches
        t0 = time.perf_counter()
        cpu_logits = copy.deepcopy(model).cpu()(image)
        cpu_s = time.perf_counter() - t0
    dlogit = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    agree = (gpu_logits.cpu().argmax(-1) == cpu_logits.argmax(-1)).float().mean().item()
    emit({"phase": "model", "card": card, "preset": PRESET, "dtype": "float32",
          "tf32": False, "input": list(image.shape), "logits": list(gpu_logits.shape),
          "max_abs_dlogit": dlogit, "tol": TOL_MODEL,
          "logit_absmax": cpu_logits.abs().max().item(), "argmax_agreement": agree,
          "kernel_launches": gpu_launches, "cpu_forward_s": cpu_s})
    check(dlogit <= TOL_MODEL, f"model f32: max |dlogit| {dlogit} > {TOL_MODEL}")
    check(bool(torch.isfinite(gpu_logits).all()), "model f32: non-finite logits")
    n_d = sum(s["launches_per_forward"] for s in stages)
    check(gpu_launches == n_d, f"model f32: {gpu_launches} K1 launches, want {n_d}")

    # ---- 5. serve: the main path, counts set to 0 just before ---------------
    server = SegInferencer(model, num_classes=cfg.num_classes, device=dev)
    rng = np.random.RandomState(SEED + 2)
    requests = [rng.randn(SERVE_BATCH, IMG, IMG, 3).astype(np.float32)
                for _ in range(SERVE_REQUESTS)]
    da.deform_attn.launches = 0
    t0 = time.perf_counter()
    outs = [server.forward_batch(r) for r in requests]
    whole = server.logits_whole(image[0].numpy())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"deform_attn_fwd": da.deform_attn.launches}
    forwards = SERVE_REQUESTS + 1
    shapes_ok = all(tuple(o.shape) == (SERVE_BATCH, IMG // 4, IMG // 4, cfg.num_classes)
                    and bool(torch.isfinite(o).all()) for o in outs)
    whole_ok = whole.shape == (IMG, IMG, cfg.num_classes) and bool(np.isfinite(whole).all())
    bf16_d = float(np.abs(whole - gpu_logits[0].cpu().numpy()).max())
    bf16_agree = float((whole.argmax(-1) == gpu_logits[0].cpu().numpy().argmax(-1)).mean())
    emit({"phase": "serve", "card": card, "dtype": "bfloat16", "requests": SERVE_REQUESTS,
          "batch": SERVE_BATCH, "whole_images": 1, "wall_s": serve_s,
          "launches": launches, "launches_per_forward": launches["deform_attn_fwd"] / forwards,
          "outputs_ok": shapes_ok and whole_ok,
          "bf16_vs_f32_max_abs_dlogit": bf16_d, "bf16_vs_f32_argmax_agreement": bf16_agree})
    check(shapes_ok and whole_ok, "serve: outputs of the wrong shape or not finite")
    check(launches["deform_attn_fwd"] == n_d * forwards,
          f"serve: {launches['deform_attn_fwd']} K1 launches, want {n_d * forwards}")

    # ---- 6. times -------------------------------------------------------------
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "ops_ms": 0.0, "bytes_ms": 0.0}
    for s in stages:
        q, k, v, pos, table = k1_inputs(B=TIME_BATCH, dtype=torch.bfloat16, **s)
        BG, H, W, Cg = q.shape
        Ns, h_g, th = s["Ns"], s["h_g"], s["th"]
        kw = dict(n_groups=s["g"], scale=scale)
        with torch.inference_mode():
            ms = timed(lambda: da.deform_attn(q, k, v, pos, table, **kw), 20)
            plain_ms = timed(lambda: da.deform_attn_reference(q, k, v, pos, table, **kw), 3, 1)
            qs = q.reshape(BG, H * W, h_g, 32).transpose(1, 2).contiguous()
            ks = k.reshape(BG, Ns, h_g, 32).transpose(1, 2).contiguous()
            vs = v.reshape(BG, Ns, h_g, 32).transpose(1, 2).contiguous()
            bias = da.rpe_bias(pos, table, H, W).to(torch.bfloat16)
            lib_ms = timed(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=bias, scale=scale), 10)
            del bias
        ops = 4.0 * BG * H * W * Ns * Cg
        nbytes = (2 * q.numel() + k.numel() + v.numel() + table.numel()) * 2 + pos.numel() * 4
        ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        n = s["launches_per_forward"]
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                         ("library_ms", lib_ms), ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            totals[key] += val * n
        emit({"phase": "kernel_time", "card": card, "kernel": "deform_attn_fwd",
              "stage": s["stage"], "dtype": "bfloat16", "batch": TIME_BATCH,
              "q": list(q.shape), "k": list(k.shape), "table": list(table.shape),
              "launches_per_forward": n, "ms": ms, "plain_ms": plain_ms,
              "library": "scaled_dot_product_attention, bias prebuilt (lookup not timed)",
              "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
              "roofline_share": bound_ms / ms})

    x16 = torch.tensor(np.random.RandomState(SEED + 3).randn(TIME_BATCH, IMG, IMG, 3),
                       dtype=torch.bfloat16, device=dev)
    fwd_ms = timed(lambda: server.forward_batch(x16), 5)
    torch.cuda.reset_peak_memory_stats()
    server.forward_batch(x16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "forward_time", "card": card, "dtype": "bfloat16", "batch": TIME_BATCH,
          "ms": fwd_ms, "ms_per_img": fwd_ms / TIME_BATCH,
          "img_per_s": TIME_BATCH / fwd_ms * 1e3, "peak_mem_gib": peak / 2 ** 30,
          "deform_attn_fwd_ms": totals["ms"],
          "deform_attn_fwd_share": totals["ms"] / fwd_ms})
    emit(profile_device(torch, lambda: server.forward_batch(x16), card, fwd_ms, "forward"))
    serve_launches = launches["deform_attn_fwd"]
    del server, model, x16
    torch.cuda.empty_cache()

    # ---- 7. train_model: one float32 step, kernel path vs plain path ---------
    from dataclasses import replace

    from dat_segmentation_tpu_torch import create_train_state, make_train_step

    ucfg = get_config(TRAIN_PRESET)
    mc = ucfg.model

    def no_warmup(model_cfg):
        return replace(ucfg, model=model_cfg, schedule=replace(ucfg.schedule, warmup_iters=0))

    def seg_batch(B, seed, device):
        rng = np.random.RandomState(seed)
        label = rng.randint(0, mc.num_classes, (B, IMG, IMG))
        label[rng.rand(B, IMG, IMG) < 0.05] = 255
        return {"image": torch.tensor(rng.randn(B, IMG, IMG, 3), dtype=torch.float32, device=device),
                "label": torch.tensor(label, dtype=torch.long, device=device)}

    quiet = replace(
        mc, backbone=replace(mc.backbone, drop_path_rate=0.0),
        decode_head=replace(mc.decode_head, kwargs={**mc.decode_head.kwargs, "dropout_ratio": 0.0}),
        auxiliary_head=replace(mc.auxiliary_head,
                               kwargs={**mc.auxiliary_head.kwargs, "dropout_ratio": 0.0}),
    )
    torch.manual_seed(SEED)
    gmodel = build_model(quiet, device=dev)
    cmodel = copy.deepcopy(gmodel).cpu()
    b2 = seg_batch(2, SEED + 4, "cpu")
    runs = {}
    for where, m in (("card", gmodel), ("cpu", cmodel)):
        st = create_train_state(m, no_warmup(quiet))
        stp = make_train_step(m, aux_weight=mc.aux_loss_weight, num_classes=mc.num_classes,
                              compute_dtype=torch.float32)
        da.deform_attn.launches = da.deform_attn_bwd.launches = 0
        t0 = time.perf_counter()
        _, met = stp(st, b2)
        if where == "card":
            torch.cuda.synchronize()
        runs[where] = dict(metrics={k: v.cpu() for k, v in met.items()},
                           seconds=time.perf_counter() - t0,
                           launches=(da.deform_attn.launches, da.deform_attn_bwd.launches))
    gm, cm = runs["card"]["metrics"], runs["cpu"]["metrics"]
    loss_rel = abs(gm["loss"].item() - cm["loss"].item()) / abs(cm["loss"].item())
    dsq = gsq = 0.0
    per_param = []
    for (name, pg), (_, pc) in zip(gmodel.named_parameters(), cmodel.named_parameters()):
        d = (pg.grad.cpu() - pc.grad).norm().item()
        gn = pc.grad.norm().item()
        dsq, gsq = dsq + d * d, gsq + gn * gn
        per_param.append((d, gn, name))
    grad_rel = (dsq / gsq) ** 0.5
    # the worst of the parameters whose gradient is not float32 noise
    worst = max((t for t in per_param if t[1] > 1e-6 * gsq ** 0.5), key=lambda t: t[0] / t[1])
    off = [n for d, g, n in per_param if d > TOL_GRAD_PARAM * g + 1e-6 * gsq ** 0.5]
    bn_err = max((b.cpu() - cb).abs().max().item()
                 for (n, b), (_, cb) in zip(gmodel.named_buffers(), cmodel.named_buffers())
                 if n.endswith(("running_mean", "running_var")))
    iou_diff = int((gm["inter"] - cm["inter"]).abs().sum() + (gm["union"] - cm["union"]).abs().sum())
    pixels = b2["label"].numel()
    n_d = sum(s["launches_per_forward"] for s in stages)
    emit({"phase": "train_model", "card": card, "preset": TRAIN_PRESET, "dtype": "float32",
          "tf32": False, "batch": list(b2["image"].shape), "drop_path": 0.0, "dropout": 0.0,
          "loss_card": gm["loss"].item(), "loss_cpu": cm["loss"].item(), "loss_rel_err": loss_rel,
          "grad_rel_err": grad_rel, "worst_param": worst[2],
          "worst_param_rel_err": worst[0] / max(worst[1], 1e-30),
          "worst_param_grad_norm": worst[1], "grad_norm_total": gsq ** 0.5,
          "largest_grad_errs": [{"param": n, "abs": d, "norm": g}
                                for d, g, n in sorted(per_param, reverse=True)[:6]],
          "bn_stats_max_abs_err": bn_err, "iou_counts_equal": iou_diff == 0,
          "iou_count_abs_diff": iou_diff, "pixels": pixels,
          "launches": {"deform_attn_fwd": runs["card"]["launches"][0],
                       "deform_attn_bwd": runs["card"]["launches"][1]},
          "card_step_s": runs["card"]["seconds"], "cpu_step_s": runs["cpu"]["seconds"],
          "tol": {"loss": TOL_TRAIN_LOSS, "grad": TOL_GRAD, "grad_param": TOL_GRAD_PARAM,
                  "bn": TOL_BN}})
    check(loss_rel <= TOL_TRAIN_LOSS, f"train_model: loss rel err {loss_rel} > {TOL_TRAIN_LOSS}")
    check(grad_rel <= TOL_GRAD, f"train_model: grad rel err {grad_rel} > {TOL_GRAD}")
    check(not off, f"train_model: gradients beyond {TOL_GRAD_PARAM}: {off}")
    check(bn_err <= TOL_BN, f"train_model: BN statistics off by {bn_err} > {TOL_BN}")
    # argmax near-ties may flip under float32 rounding: a few pixels, never more
    check(iou_diff <= 1e-4 * pixels, f"train_model: IoU counts differ by {iou_diff}")
    check(runs["card"]["launches"] == (n_d, n_d),
          f"train_model: launches {runs['card']['launches']}, want ({n_d}, {n_d})")
    del gmodel, cmodel, runs
    torch.cuda.empty_cache()

    # ---- 8. train: the main path, counts set to 0 just before ----------------
    cfg_train = no_warmup(mc)
    torch.manual_seed(SEED)
    model = build_model(mc, device=dev)
    state = create_train_state(model, cfg_train)
    step = make_train_step(model, aux_weight=mc.aux_loss_weight,
                           ignore_index=cfg_train.data.ignore_index,
                           num_classes=mc.num_classes, compute_dtype=torch.bfloat16)
    b16 = seg_batch(TRAIN_BATCH, SEED + 5, dev)
    torch.cuda.synchronize()
    da.deform_attn.launches = da.deform_attn_bwd.launches = 0
    t0 = time.perf_counter()
    mets = [step(state, b16)[1] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {"deform_attn_fwd": da.deform_attn.launches,
                      "deform_attn_bwd": da.deform_attn_bwd.launches}
    losses = [m["loss"].item() for m in mets]
    gnorms = [m["grad_norm"].item() for m in mets]
    emit({"phase": "train", "card": card, "preset": TRAIN_PRESET, "dtype": "bfloat16",
          "batch": TRAIN_BATCH, "img": IMG, "steps": TRAIN_STEPS,
          "drop_path_rate": mc.backbone.drop_path_rate,
          "dropout": mc.decode_head.kwargs.get("dropout_ratio", 0.1), "warmup_iters": 0,
          "lr": state.schedule(0), "loss_step1": losses[0], f"loss_step{TRAIN_STEPS}": losses[-1],
          "losses": losses, "grad_norms": gnorms,
          "update_ratios": [m["update_ratio"].item() for m in mets],
          "launches": train_launches,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in train_launches.items()},
          "wall_s": train_s})
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train: non-finite loss or grad norm: {losses} {gnorms}")
    for name, n in train_launches.items():
        check(n == n_d * TRAIN_STEPS, f"train: {n} {name} launches, want {n_d * TRAIN_STEPS}")

    # ---- 9. train times: K2 per stage, the step, its profile ------------------
    btot = {key: 0.0 for key in totals}
    for s in stages:
        q, k, v, pos, table = k1_inputs(B=TIME_BATCH, dtype=torch.bfloat16, **s)
        dout = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(SEED),
                           device=dev).to(torch.bfloat16)
        BG, H, W, Cg = q.shape
        Ns, h_g = s["Ns"], s["h_g"]
        kw = dict(n_groups=s["g"], scale=scale)
        ms = timed(lambda: da.deform_attn_bwd(q, k, v, pos, table, dout, **kw), 10)
        plain_ms = timed(lambda: da.deform_attn_bwd_reference(q, k, v, pos, table, dout, **kw), 3, 1)
        heads = [t.reshape(BG, -1, h_g, 32).transpose(1, 2).contiguous().requires_grad_(True)
                 for t in (q, k, v)]
        bias = da.rpe_bias(pos, table, H, W).to(torch.bfloat16).requires_grad_(True)
        out = F.scaled_dot_product_attention(*heads, attn_mask=bias, scale=scale)
        d_out = dout.reshape(BG, H * W, h_g, 32).transpose(1, 2).contiguous()
        lib_ms = timed(lambda: torch.autograd.grad(out, heads + [bias], d_out, retain_graph=True), 5)
        del out, heads, bias
        ops = 10.0 * BG * H * W * Ns * Cg
        nbytes = ((3 * q.numel() + k.numel() + v.numel() + table.numel()) * 2
                  + (k.numel() + v.numel() + 2 * pos.numel() + table.numel()) * 4)
        ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        n = s["launches_per_forward"]
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                         ("library_ms", lib_ms), ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            btot[key] += val * n
        emit({"phase": "kernel_time", "card": card, "kernel": "deform_attn_bwd",
              "stage": s["stage"], "dtype": "bfloat16", "batch": TIME_BATCH,
              "q": list(q.shape), "k": list(k.shape), "table": list(table.shape),
              "launches_per_step": n, "ms": ms, "plain_ms": plain_ms,
              "library": "scaled_dot_product_attention backward, bias prebuilt and requiring "
                         "grad (the bias -> pos, table chain not timed)",
              "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
              "roofline_share": bound_ms / ms})

    step_ms = timed(lambda: step(state, b16), TIME_STEPS, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step(state, b16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prof = profile_device(torch, lambda: step(state, b16), card, step_ms, "step", iters=2)
    k12 = sum(ms for name, ms in prof.get("kernels_ms", {}).items())
    emit({"phase": "train_time", "card": card, "dtype": "bfloat16", "batch": TRAIN_BATCH,
          "ms_per_step": step_ms, "img_per_s": TRAIN_BATCH / step_ms * 1e3,
          "peak_mem_gib": peak / 2 ** 30, "deform_attn_fwd_ms": totals["ms"],
          "deform_attn_bwd_ms": btot["ms"],
          "k1_k2_share_profiled": k12 / prof["device_ms_per_step"] if "kernels_ms" in prof else None})
    emit(prof)

    # ---- kernels line, card, verdict ----------------------------------------
    def line(kernel, n, err, tot):
        return dict(kernel, launches=n, max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                    bound_ms=tot["bound_ms"],
                    bound_by="operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
                    library_ms=tot["library_ms"])

    k1 = line(KERNELS[0], train_launches["deform_attn_fwd"], max_err, totals)
    k1["launches_by_path"] = {"serve": serve_launches, "train": train_launches["deform_attn_fwd"]}
    k2 = line(KERNELS[1], train_launches["deform_attn_bwd"], max_err_bwd, btot)
    k2["max_rel_err"] = max_rel_bwd
    emit({"kernels": [k1, k2]})
    print(f"chip_smoke: wall {time.perf_counter() - T_START:.1f} s", file=sys.stderr, flush=True)
    if failures:
        print("chip_smoke: failed: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


KERNEL_NAMES = ("deform_attn_fwd_kernel", "deform_attn_bwd_kernel")


def x_block_bound(bb, stages, card, batch=TIME_BATCH, expansion=4):
    """The least time of the TPU kernel K3 (``ops/pallas/x_block.py:227``
    ``_fwd_pallas``, not ported yet) per forward of the flagship at
    ``batch``, bf16: x read, out written and the weights read once over
    the memory rate; the fc1/fc2 and depthwise products over the bf16
    rate. It runs in 'X' blocks (LPU dw3 + dw7 window) and, in MLP-only
    mode (k = 1), in the second half of each 'D' block. Arithmetic only."""
    rows, tot = [], {"ops_ms": 0.0, "bytes_ms": 0.0, "bound_ms": 0.0}
    for s in stages:
        C, H, W = bb.dims[s["stage"]], s["H"], s["W"]
        E, n = expansion * C, batch * H * W
        for mode, k, lpu, calls in (("X", bb.window_sizes[s["stage"]], True,
                                     bb.stage_spec[s["stage"]].count("X")),
                                    ("mlp", 1, False, s["launches_per_forward"])):
            if not calls:
                continue
            weights = (9 * C + C if lpu else 0) + k * k * C + C + 2 * C + 2 * C * E + E \
                + 9 * E + E + C
            ops = 2.0 * n * 2 * C * E + 2.0 * n * (C * ((9 if lpu else 0) + k * k) + 9 * E)
            nbytes = (2 * n * C + weights) * 2
            ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            bound = max(ops_ms, bytes_ms)
            rows.append({"stage": s["stage"], "mode": mode, "x": [batch, H, W, C], "k": k,
                         "calls_per_forward": calls, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                         "bound_ms": bound,
                         "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
            for key, val in (("ops_ms", ops_ms), ("bytes_ms", bytes_ms), ("bound_ms", bound)):
                tot[key] += val * calls
    return {"phase": "bound", "card": card, "kernel": "x_block (K3, not ported)",
            "replaces": "dat_segmentation_tpu/ops/pallas/x_block.py:227", "dtype": "bfloat16",
            "batch": batch, "per_forward": tot, "rows": rows}


def profile_device(torch, fn, card, ref_ms, unit, iters=3):
    """Device time of a few calls of ``fn`` by kernel name; the busy share
    is that time over ``ref_ms``, one call timed with CUDA events and no
    profiler (the profiler's own host work stretches the wall time it
    sees). ``unit`` names a call ('forward', 'step')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host ops also carry their kernels' device time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / iters, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    if device_ms == 0:
        return {"phase": "profile", "card": card, "unit": unit, "device_time": "not measured"}
    return {"phase": "profile", "card": card, "unit": unit, "dtype": "bfloat16", "iters": iters,
            f"profiled_wall_ms_per_{unit}": wall_ms / iters,
            f"device_ms_per_{unit}": device_ms, f"{unit}_ms": ref_ms,
            "device_busy_share": device_ms / ref_ms,
            "kernels_ms": {name: sum(ms for ms, k in rows if name in k) for name in KERNEL_NAMES},
            "top": [{"kernel": k[:100], f"ms_per_{unit}": ms, "share": ms / device_ms}
                    for ms, k in rows[:12]]}


if __name__ == "__main__":
    sys.exit(main())
