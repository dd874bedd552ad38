"""The segmentation train step from ``make_train_step``, step after step.

Set-up builds one train state (the model with the seed's float32 weights,
AdamW, the schedule) and drives it through its first ``check_steps`` steps,
which are also its warm-up, on distinct batches of the pool; their losses,
each leaf's gradient as AdamW got it at the first step (its first moment
over 1 - beta1) and each leaf's change over those steps are kept. The same
state then steps through the window on the pool's batches in turn. The
state starts at ``start_step`` of the schedule (the end of warm-up: the
learning rate of the run's body; at the warm-up's 1e-6 an update is below
a float32 weight's rounding). Drop path and the heads' dropout draw from the
state's generator, seeded by the benchmark.

After the window the reference (float32, no TF32) takes the same steps from
the same weights on the same batches, drawing the same masks:
``loss_gap``, ``grad_gap``, ``change_gap`` (``bench_port/check.py``).

Traffic keys: ``batch``, ``shape`` [H, W], ``classes``, ``ignore_share``
(labels set to the ignore index), ``pool``, ``check_steps``, ``warmup``
(further steps before the window), ``start_step``, ``trace_seconds``.
"""

from __future__ import annotations

import gc
import time

import torch

from bench_port.check import exact_float32, reference_model, reference_shapes, train_gaps
from bench_port.harness import Outcome, memory_peak, release, sync
from bench_port.reference.train import run_steps
from bench_port.trace import run_traced
from bench_port.weights import make_weights, normal_images

OPTIMIZER_RANGE = "Optimizer.step#AdamW.step"  # torch's own profiler range


def make_pool(cell, device):
    """The pool's images (pool·batch, H, W, 3) and labels (pool·batch, H, W)."""
    tr = cell.traffic
    n, (H, W) = tr["pool"] * tr["batch"], tr["shape"]
    gen = torch.Generator(device=device).manual_seed(cell.seed_for("inputs"))
    images = normal_images(n, H, W, gen, device)
    labels = torch.randint(0, tr["classes"], (n, H, W), generator=gen, device=device)
    ignore = torch.rand(n, H, W, generator=gen, device=device) < tr["ignore_share"]
    labels[ignore] = cell.config["train_config"]["data"]["ignore_index"]
    return images, labels


def build_step(cell, device):
    """The program's train state and step over the seed's weights."""
    from dat_segmentation_tpu_torch.models.builder import build_model
    from dat_segmentation_tpu_torch.train.train_step import create_train_state, make_train_step

    cfg = cell.program_config()
    with torch.device("meta"):
        model = build_model(cfg.model, device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(make_weights(reference_shapes(cell.config), cell.seed_for("weights"),
                                       device))
    state = create_train_state(model, cfg)
    state.step = cell.traffic["start_step"]
    state.generator.manual_seed(cell.seed_for("masks"))
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    step = make_train_step(model, aux_weight=cfg.model.aux_loss_weight,
                           ignore_index=cfg.data.ignore_index,
                           num_classes=cfg.model.num_classes, compute_dtype=dtype)
    return model, state, step


def first_steps(model, state, step, batch):
    """The checked steps: each one's loss, each leaf's first gradient (AdamW's
    first moment over 1 - beta1) and each leaf's change over them."""
    params = list(model.parameters())
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    start = [p.detach().clone() for p in params]
    losses, grad = [], None
    for i in range(len(batch)):
        state, metrics = step(state, batch[i])
        losses.append(metrics["loss"])
        if i == 0:
            moments = [state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                       / (1.0 - beta1) for p in params]
            grad = torch.stack([torch.linalg.vector_norm(m.float()) for m in moments]).tolist()
            del moments
    change = torch.stack([torch.linalg.vector_norm((p.detach() - s).float())
                          for p, s in zip(params, start)]).tolist()
    return {"losses": [float(x) for x in losses], "grad": grad, "change": change}


def run(cell) -> Outcome:
    tr, device = cell.traffic, cell.device
    B, P, n_check = tr["batch"], tr["pool"], tr["check_steps"]
    cell.mark("build")
    model, state, step = build_step(cell, device)
    cell.mark("pool")
    images, labels = make_pool(cell, device)

    def batch(i):
        p = i % P
        return {"image": images[p * B:(p + 1) * B], "label": labels[p * B:(p + 1) * B]}

    cell.mark("first_steps")
    prog = first_steps(model, state, step, [batch(i) for i in range(n_check)])
    for i in range(n_check, n_check + tr["warmup"]):
        step(state, batch(i))
    sync(device)
    gc.collect()
    gc.freeze()  # what set-up left is not scanned again by the window's collections
    cell.mark("window")
    setup_s = time.perf_counter() - cell.t_start

    steps = [0]

    def loop(seconds):
        t0 = time.perf_counter()
        i = n_check + tr["warmup"]
        while time.perf_counter() - t0 < seconds:
            with torch.profiler.record_function("bench.step"):
                step(state, batch(i))
            i += 1
            steps[0] += 1
        sync(device)
        return time.perf_counter() - t0

    trace = None
    if cell.trace:
        trace = run_traced(lambda: loop(tr["trace_seconds"]), lambda: sync(device),
                           (OPTIMIZER_RANGE,))
    else:
        window = loop(cell.seconds)
    peak = memory_peak(device)
    del model, state, step
    release(device)

    cell.mark("check")
    t_check = time.perf_counter()
    exact_float32()
    ref = reference_model(cell.config, device, cell.seed_for("weights"), None)
    checked = [(batch(i)["image"], batch(i)["label"]) for i in range(n_check)]
    ref_run = run_steps(ref, cell.config["train_config"], checked, tr["start_step"],
                        cell.seed_for("masks"), device)
    gaps = dict(train_gaps(prog, ref_run), check_s=time.perf_counter() - t_check)

    e2e, run_info = {}, {"units": steps[0], "batch": B}
    if cell.trace:
        from bench_port.metrics.yardstick import count_work

        work = count_work(cell.config["train_config"]["model"], 1, tr["shape"], True)
        run_info.update(flops=work["flops"] * B, calls=work["calls"], lse=True,
                        optimizer_range=OPTIMIZER_RANGE)
    else:
        e2e = {"train_img_per_s": steps[0] * B / window, "setup_s": setup_s}
    return Outcome(attempted=steps[0], failed=0, end_to_end=e2e, checks=gaps,
                   memory_peak=peak, run=run_info, trace=trace)
