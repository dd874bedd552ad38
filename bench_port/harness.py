"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its traffic's driver, reads the per-layer metrics and prints the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name: ``configs/<config>.json`` (the ``file`` of
the configuration's entry), ``traffic/<traffic>.json`` (whose ``kind`` names
the driver ``drivers/<kind>.py``), ``limits/<workload>.json`` (the limit of
each number the correctness check compares) and ``metrics/<metric>.py`` (a
reader with ``read(run)``, which returns the metric or None when it finds
nothing to read). A new cell, mix or metric is new files and entries, and no
edit of a file that is here.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "dat_segmentation_tpu")  # whole top-level names


def banned_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the port's benchmark must not
    load: JAX, flax and the JAX package (compared whole: the port's own
    name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """The module at ``path`` (a file name may hold dots: ``k1_roofline.serve.py``)."""
    name = "bench_port_" + "_".join(path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def release(device) -> None:
    """Free what nothing holds any more, on the host and the card."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def derived_seed(seed: int, tag: str) -> int:
    """A seed of ``tag``'s draws, from the run's ``--seed`` (any whole number)."""
    return int(hashlib.sha256(f"{seed}:{tag}".encode()).hexdigest()[:15], 16)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _plain(v):
    return json.loads(json.dumps(v))


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files, for one run."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float

    def seed_for(self, tag: str) -> int:
        return derived_seed(self.seed, tag)

    def mark(self, phase: str) -> None:
        """Say on standard error when a phase of the run began (set-up's cost)."""
        print(f"phase {phase} at {time.perf_counter() - self.t_start:.3f} s", file=sys.stderr,
              flush=True)

    def program_config(self):
        """The program's ``TrainConfig``: its preset with the file's ``set``
        applied, held equal to the file's ``train_config`` (the configuration
        as run), the seed the run's."""
        import dataclasses

        from dat_segmentation_tpu_torch.configs.presets import get_config
        from dat_segmentation_tpu_torch.configs.schema import replace

        cfg = get_config(self.config["preset"])
        sets = {k: _tuples(v) for k, v in self.config.get("set", {}).items()}
        if sets:
            cfg = replace(cfg, **sets)
        got, want = _plain(dataclasses.asdict(cfg)), self.config["train_config"]
        for key in ("model", "optimizer", "schedule", "data", "dtype"):
            if got[key] != want[key]:
                raise ValueError(f"{self.config['name']}: the program's {key} is not the "
                                 f"configuration file's")
        return dataclasses.replace(cfg, seed=self.seed_for("program") % 2 ** 31)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
              t_start: float, bench: Optional[dict] = None,
              files: Optional[Dict[str, Path]] = None) -> Cell:
    """The cell ``workload`` of ``bench`` (``BENCHMARK.json``); ``files``
    names other config, traffic or limits files (the tests' small cells)."""
    bench = bench if bench is not None else load_json(REPO / "BENCHMARK.json")
    files = files or {}
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[workload]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(
        name=workload, entry=entry,
        config=load_json(files.get("config", REPO / conf["file"])),
        traffic=load_json(files.get("traffic", HERE / "traffic" / f"{entry['traffic']}.json")),
        limits=load_json(files.get("limits", HERE / "limits" / f"{workload}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device,
        t_start=t_start,
    )


@dataclass
class Outcome:
    """What a driver's run gives back."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, float]  # number compared -> its reading
    memory_peak: int
    run: dict = field(default_factory=dict)  # what the metric readers read
    trace: object = None  # a trace.Trace of a --trace 1 run


def per_layer_values(cell: Cell, outcome: Outcome) -> Dict[str, float]:
    """Each per-layer metric of the cell that its reader finds."""
    run = dict(outcome.run, trace=outcome.trace, cell=cell)
    out = {}
    for m in cell.per_layer:
        value = load_file(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def result(cell: Cell, outcome: Outcome, device: dict) -> Tuple[dict, List[str]]:
    """The result line's object and the check lines for standard error."""
    checks, lines, correct = {}, [], outcome.failed == 0 and outcome.attempted > 0
    for name, value in outcome.checks.items():
        if name not in cell.limits:  # a reading kept beside the compared ones
            lines.insert(0, f"reading {name} = {value!r}")
            continue
        limit = cell.limits[name]
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} = {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}")
    if cell.trace:
        values = per_layer_values(cell, outcome)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        values = outcome.end_to_end
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    metrics = {n: {"value": v, "unit": units[n]} for n, v in values.items() if n in units}
    out = {"correct": bool(correct), "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": device}
    if cell.trace and outcome.trace is not None:
        out["device"] = dict(device, busy_s=outcome.trace.busy_s,
                             window_s=outcome.trace.window_s)
        out["breakdown"] = outcome.trace.breakdown()
    out["checks"] = checks
    return out, lines


def run_cell(cell: Cell, patch=None) -> Tuple[dict, List[str]]:
    """Run ``cell`` through its traffic's driver. ``patch`` (the tests'):
    called with the driver module before the run."""
    driver = load_file(HERE / "drivers" / f"{cell.traffic['kind']}.py")
    if patch is not None:
        patch(driver)
    outcome = driver.run(cell)
    import torch

    device = {"platform": "gpu" if cell.device == "cuda" else cell.device,
              "kind": torch.cuda.get_device_name(0) if cell.device == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(outcome.memory_peak)}
    return result(cell, outcome, device)
