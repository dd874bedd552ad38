"""``dispatch_ms.serve``: the median host time from the start of a
``SegInferencer.forward_batch`` call to its return, without a synchronise,
over the traced window's requests (the host's share of a request)."""

import statistics


def read(run):
    return statistics.median(run["dispatch_s"]) * 1e3 if run.get("dispatch_s") else None
