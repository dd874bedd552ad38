"""``mfu.train``: the model's FLOPs (a step's forward and backward, counted once from
shapes by ``yardstick.count_work``) times the traced window's steps, over the
window's time and the card's bf16 peak, as a percentage."""

from bench_port.metrics.yardstick import PEAK_BF16_FLOPS


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("flops") or not run.get("units") or trace.window_s <= 0:
        return None
    return 100.0 * run["flops"] * run["units"] / trace.window_s / PEAK_BF16_FLOPS
