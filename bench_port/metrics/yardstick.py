"""The benchmark's own arithmetic: the card's peaks, the operations and bytes
of the deformable-attention kernels at given shapes, and the model's FLOPs
counted once from shapes.

The FLOPs are ``FlopCounterMode``'s count of the reference model on the meta
device (no memory, no data), with the attention core, which the program runs
as one kernel, taken out and counted by its formula: 4·BG·H·W·Ns·Cg a
forward (q·kᵀ and P·v). A train step's backward counts twice its forward's
products (each product's two gradients; no recomputation), the forward
taken in training (with the auxiliary head): ``FlopCounterMode``'s own count
of a backward is not used, as it counts a depthwise convolution's gradient
as a dense one's. So a roofline or an MFU reads the same work
whatever implements it. The kernels' least times follow ``chip_smoke.py``
(PERF.md §6): K1 reads q, k, v, the table and the positions once and writes
its output (and, in training, its log-sum-exp); K2 counts 10·BG·H·W·Ns·Cg
products (the gradient's four and the scores again) and reads q, k, v, the
table, dout and the positions and writes the gradients once.
"""

from __future__ import annotations

from typing import Dict, List

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3


def stage_geometry(bb: dict, img: int) -> List[dict]:
    """K1's shapes at each stage of backbone config ``bb`` on an img x img
    input (``chip_smoke.py``'s ``stage_geometry``): groups, heads a group,
    channels a group, the query grid, the samples, the table side, launches
    a forward."""
    stages = []
    for i in range(4):
        H = img // bb["patch_size"] // 2 ** i
        ks, st = bb["ksizes"][i], bb["strides"][i]
        Hk = (H + 2 * (ks // 2 if ks != st else 0) - ks) // st + 1
        q_size = bb["img_size"] // bb["patch_size"] // 2 ** i
        stages.append(dict(stage=i, g=bb["groups"][i], h_g=bb["heads"][i] // bb["groups"][i],
                           Cg=bb["dims"][i] // bb["groups"][i], H=H, W=H, Ns=Hk * Hk,
                           th=2 * q_size - 1, tw=2 * q_size - 1,
                           launches=list(bb["stage_spec"][i]).count("D")))
    return stages


def k1_bound_s(calls: List[dict], batch: int, elem: int = 2, lse: bool = False) -> float:
    """Least time of K1 over ``calls`` (dicts of g, h_g, Cg, H, W, Ns, th, tw,
    launches) at ``batch``: each launch the larger of its products over the
    peak rate and its bytes once over the memory rate."""
    total = 0.0
    for c in calls:
        BG = batch * c["g"]
        q = BG * c["H"] * c["W"] * c["Cg"]
        kv = BG * c["Ns"] * c["Cg"]
        table = c["g"] * c["h_g"] * c["th"] * c["tw"]
        pos = BG * c["Ns"] * 2
        ops = 4.0 * q * c["Ns"]
        nbytes = (2 * q + 2 * kv + table) * elem + pos * 4
        if lse:
            nbytes += BG * c["h_g"] * c["H"] * c["W"] * 4
        total += max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * c["launches"]
    return total


def k2_bound_s(calls: List[dict], batch: int, elem: int = 2) -> float:
    """Least time of K2 over ``calls`` at ``batch`` (PERF.md §6's count)."""
    total = 0.0
    for c in calls:
        BG = batch * c["g"]
        q = BG * c["H"] * c["W"] * c["Cg"]
        kv = BG * c["Ns"] * c["Cg"]
        table = c["g"] * c["h_g"] * c["th"] * c["tw"]
        pos = BG * c["Ns"] * 2
        ops = 10.0 * q * c["Ns"]
        nbytes = (3 * q + 2 * kv + table) * elem + (2 * kv + 2 * pos + table) * 4
        total += max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * c["launches"]
    return total


def count_work(model_cfg: dict, batch: int, hw, train: bool) -> Dict[str, object]:
    """The reference's work at ``batch`` images of ``hw``: ``flops`` (a
    forward, or with ``train`` a forward and its backward) and ``calls``, the
    attention cores' shapes, one dict a call."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.model import Drop, Segmentor

    calls: List[dict] = []
    attn = [0.0]

    def core(q, k, v, pos, table, scale):
        BG, H, W, Cg = q.shape
        g, h_g, th, tw = table.shape
        calls.append(dict(g=g, h_g=h_g, Cg=Cg, H=H, W=W, Ns=k.shape[1], th=th, tw=tw,
                          launches=1))
        attn[0] += 4.0 * BG * H * W * k.shape[1] * Cg
        return q * 1.0 + (k.sum() + v.sum() + pos.sum() + table.sum()) * 0.0

    with torch.device("meta"):
        model = Segmentor(model_cfg)
    model.ctx.attn_core = core
    for m in model.modules():
        if isinstance(m, Drop):
            m.rate = 0.0  # elementwise: no products; the meta device has no generator
    x = torch.empty(batch, hw[0], hw[1], 3, device="meta")
    model.train(train)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x, upsample=train)
    flops = (counter.get_total_flops() + attn[0]) * (3.0 if train else 1.0)
    return {"flops": float(flops), "calls": calls}
