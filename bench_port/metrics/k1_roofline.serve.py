"""``k1_roofline.serve``: K1's least time at the cell's attention shapes
(the larger of its products over the bf16 peak and its bytes once over the
memory rate, ``yardstick.k1_bound_s``) over the device time of the kernels
named ``deform_attn_fwd``, in the traced window, as a percentage."""

from bench_port.metrics.yardstick import k1_bound_s

KERNEL = "deform_attn_fwd"


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("calls"):
        return None
    seconds = trace.device_s(KERNEL)
    if seconds <= 0:
        return None
    bound = k1_bound_s(run["calls"], run["batch"], lse=run["lse"]) * run["units"]
    return 100.0 * bound / seconds
