"""``idle_share.serve``: the share of the traced window in which no
operation runs on the card (the union of the device operations' intervals
against the window), as a percentage."""


def read(run):
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
