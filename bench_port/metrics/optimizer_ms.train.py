"""``optimizer_ms.train``: device time of the kernels launched under torch's
own ``Optimizer.step#AdamW.step`` range, a step, over the traced window."""


def read(run):
    trace, steps = run.get("trace"), run.get("units", 0)
    name = run.get("optimizer_range")
    if trace is None or not steps or name is None:
        return None
    seconds = trace.range_device_s.get(name, 0.0)
    return seconds / steps * 1e3 if seconds > 0 else None
