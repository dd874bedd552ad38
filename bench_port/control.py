"""Readings that set a cell's limits: the program's, the control's and the
faults', on several seeds, in one process and without a timed window.

    python3 bench_port/control.py --workload <name> --seeds 11,12,13 [--out file.jsonl]

For each seed, on the inputs and weights a benchmark run with that
``--seed`` makes and checks:

* ``program``: the program's numbers (its requests' logits, or its first
  train steps) against the float32 reference, as a run compares them;
* ``control``: the reference put in the program's place, its products'
  inputs and weights rounded through float8 (``reference.model.
  float8_round``: the precision below the configuration's bf16), against the
  float32 reference;
* train cells also ``half_batch``: the reference stepping on half of each
  batch, the mean over the rest, against the reference on the whole; and
  ``nudged``: the float32 reference on its images moved by a relative 2^-9
  (bf16's rounding), against itself: how far a number swings on rounding
  alone.

The benchmark's runs do not run this; its tests run it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def serve_readings(cell, driver) -> dict:
    from bench_port.check import exact_float32, reference_model
    from bench_port.harness import release
    from bench_port.reference.model import float8_round

    device, tr = cell.device, cell.traffic
    B = tr["batch"]
    images, sizes = driver.make_pool(cell, device)
    picks = list(range(tr["check_requests"]))
    server = driver.build_server(cell, device)
    with torch.no_grad():
        outs = [(p, server.forward_batch(images[p * B:(p + 1) * B]) if sizes is None else
                 server.forward_batch(images[p * B:(p + 1) * B], sizes[p * B:(p + 1) * B]))
                for p in picks]
    del server
    release(device)
    exact_float32()
    ref = reference_model(cell.config, device, cell.seed_for("weights"), torch.bfloat16)
    program = driver.reference_gap(cell, device, outs, images, sizes, model=ref)
    del outs
    ctrl = reference_model(cell.config, device, cell.seed_for("weights"), torch.bfloat16).eval()
    ctrl.ctx.quant = float8_round
    with torch.no_grad():
        shape = (B,) + tuple(ctrl(images[:1], upsample=False).shape[1:])
    couts = []
    with torch.no_grad():
        for p in picks:
            out = torch.zeros(shape, device=device)
            for j in range(B):
                x = images[p * B + j:p * B + j + 1]
                if sizes is not None:
                    x = x[:, :int(sizes[p * B + j][0]), :int(sizes[p * B + j][1])]
                y = ctrl(x, upsample=False)[0]
                out[j, :y.shape[0], :y.shape[1]] = y
            couts.append((p, out))
    control = driver.reference_gap(cell, device, couts, images, sizes, model=ref)
    return {"program": {"logit_rel_l2": program}, "control": {"logit_rel_l2": control}}


def train_readings(cell, driver, leaves: bool = False) -> dict:
    from bench_port.check import exact_float32, reference_model, train_gaps, worst_leaves
    from bench_port.harness import release
    from bench_port.reference.model import float8_round
    from bench_port.reference.train import run_steps

    device, tr = cell.device, cell.traffic
    B, n = tr["batch"], tr["check_steps"]
    images, labels = driver.make_pool(cell, device)
    batches = [(images[i * B:(i + 1) * B], labels[i * B:(i + 1) * B]) for i in range(n)]
    model, state, step = driver.build_step(cell, device)
    prog = driver.first_steps(model, state, step,
                              [{"image": x, "label": y} for x, y in batches])
    del model, state, step
    release(device)
    exact_float32()
    args = (cell.config["train_config"],)

    def steps(quant=None, half=False, nudge=0.0):
        ref = reference_model(cell.config, device, cell.seed_for("weights"), None)
        ref.ctx.quant = quant
        data = [(x[:B // 2], y[:B // 2]) for x, y in batches] if half else batches
        if nudge:  # the images moved by a relative ``nudge``: how far the numbers swing alone
            gen = torch.Generator(device=device).manual_seed(cell.seed_for("nudge"))
            data = [(x * (1.0 + nudge * (2.0 * torch.rand(x.shape, generator=gen, device=device)
                                         - 1.0)), y) for x, y in data]
        out = run_steps(ref, *args, data, tr["start_step"], cell.seed_for("masks"), device)
        del ref
        release(device)
        return out

    ref = steps()
    ctrl, half = steps(float8_round), steps(half=True)
    out = {"program": train_gaps(prog, ref), "control": train_gaps(ctrl, ref),
           "half_batch": train_gaps(half, ref),
           "nudged": train_gaps(steps(nudge=2.0 ** -9), ref),
           "look": {"program": worst_leaves(prog, ref), "control": worst_leaves(ctrl, ref)}}
    if leaves:  # every leaf's norms, for a look at other numbers
        out["leaves"] = {"names": ref["names"], **{f"{side}_{k}": run[k] for side, run in (
            ("ref", ref), ("program", prog), ("control", ctrl), ("half", half))
            for k in ("losses", "grad", "change")}}
    return out


def readings(workload: str, seed: int, device: str = "cuda", files=None,
             leaves: bool = False) -> dict:
    """The program's, the control's (and a train cell's half-batch fault's)
    numbers on ``seed``'s inputs; ``files`` as ``harness.load_cell``'s."""
    from bench_port import harness

    cell = harness.load_cell(workload, seed, 0.0, False, device, 0.0, files=files)
    driver = harness.load_file(harness.HERE / "drivers" / f"{cell.traffic['kind']}.py")
    if cell.traffic["kind"] == "train":
        return {"workload": workload, "seed": seed, **train_readings(cell, driver, leaves)}
    return {"workload": workload, "seed": seed, **serve_readings(cell, driver)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", default=None, help="also append each seed's line to this file")
    p.add_argument("--device", default="cuda")
    p.add_argument("--leaves", action="store_true", help="train: every leaf's norms too")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_port.harness import release

    torch.set_num_threads(4)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, args.device, leaves=args.leaves))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        release(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
