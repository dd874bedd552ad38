"""Where a split step's float32 gradient departs from the one-process step's.

The flagship (``upn_tiny_160k_dp03_lr6``, float32, TF32 off, warm-up 0)
takes one step on ``chip_smoke.py``'s model-axis batch (two rows made from
its seed) twice: over two gloo ranks on the card at ``{data: 1, model: 2}``
with ``fsdp='model'``, and in one process. Each split
``DeformableAttention``'s offsets and the gradient that reaches them are
recorded on both sides; per block the script prints the relative
difference of that gradient and, for the elements that differ most, both
values, the sample's pixel coordinates and their distance to the nearest
bilinear cell edge (where the sampled map's slope, and so the gradient,
jumps). Then the one-process step's own sensitivity: its gradient with the
image perturbed by 1e-6 and 1e-8 relative, against the unperturbed one.
One JSON object a line. On the card::

    python -m dat_segmentation_tpu_torch.tools.axis_probe [--kernel-impl auto]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from dataclasses import replace
from pathlib import Path

SEED = 0
ROWS = (0, 3)  # chip_smoke.py's scale_batch rows that make its model-axis batch
IMG = 512


def _batch(np, num_classes):
    """chip_smoke.py's ``axis_batch``: rows 0 and 3 of its scale-out batch."""
    rng = np.random.RandomState(SEED + 21)
    label = rng.randint(0, num_classes, (4, IMG, IMG))
    label[rng.rand(4, IMG, IMG) < 0.05] = 255
    label[2:][rng.rand(2, IMG, IMG) < 0.9] = 255
    batch = {"image": rng.randn(4, IMG, IMG, 3).astype(np.float32), "label": label}
    return {k: v[list(ROWS)] for k, v in batch.items()}


def _cfg(kernel_impl):
    from dat_segmentation_tpu_torch import get_config

    cfg = get_config("upn_tiny_160k_dp03_lr6")
    bb = replace(cfg.model.backbone, kernel_impl=kernel_impl)
    return replace(cfg, dtype="float32", model=replace(cfg.model, backbone=bb),
                   schedule=replace(cfg.schedule, warmup_iters=0))


def _step(cfg, dev, record=None, perturb=0.0):
    """One step; with ``record`` each split-able attention's offsets, their
    gradient and its input's (H, W). Returns the gradients by name."""
    import numpy as np
    import torch

    from dat_segmentation_tpu_torch import build_model, create_train_state, make_train_step
    from dat_segmentation_tpu_torch.models.deformable_attention import DeformableAttention
    from dat_segmentation_tpu_torch.parallel import mesh

    torch.manual_seed(SEED)
    model = build_model(cfg.model, device=dev)
    state = create_train_state(model, cfg)
    if record is not None:
        for name, mod in model.named_modules():
            if isinstance(mod, DeformableAttention) and mod.n_groups % 2 == 0:
                def hook(m, inp, out, key=name):
                    if out.requires_grad:
                        record[key] = {"offset": out.detach().cpu()}
                        out.register_hook(lambda g: record[key].__setitem__(
                            "grad", g.detach().cpu()))

                def shape(m, inp, key=name):
                    record.setdefault("hw", {})[key] = tuple(inp[0].shape[1:3])

                mod.offset_proj.register_forward_hook(hook)
                mod.register_forward_pre_hook(shape)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in _batch(np, cfg.model.num_classes).items()}
    if perturb:
        gen = torch.Generator(device=dev).manual_seed(1)
        batch["image"] = batch["image"] * (1 + perturb * torch.randn(
            batch["image"].shape, device=dev, generator=gen))
    step = make_train_step(model, aux_weight=cfg.model.aux_loss_weight,
                           num_classes=cfg.model.num_classes, compute_dtype=torch.float32)
    step(state, batch)
    axis = mesh.model_axis_of(model)
    dims = getattr(model, "model_axis_dims", {})
    return {n: (mesh.gather_tensor(p.grad, dims[n], axis) if n in dims else p.grad).cpu()
            for n, p in model.named_parameters() if p.grad is not None}


def _rank(rank, world, tmp, kernel_impl):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dat_segmentation_tpu_torch.parallel import destroy_distributed, init_distributed

    dev = init_distributed("gloo", init_method=f"file://{tmp}/rendezvous")
    record = {}
    try:
        cfg = replace(_cfg(kernel_impl), fsdp="model", mesh_shape={"data": 1, "model": 2})
        grads = _step(cfg, dev, record)
    finally:
        destroy_distributed()
    torch.save({"record": record, "grads": grads}, Path(tmp) / f"rank{rank}.pt")


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _global_rel(got, want):
    num = sum(float((got[n].double() - w.double()).norm()) ** 2 for n, w in want.items())
    den = sum(float(w.double().norm()) ** 2 for w in want.values())
    return (num / den) ** 0.5


def main(argv=None) -> int:
    import torch
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernel-impl", default="auto", choices=("auto", "pallas"))
    p.add_argument("--top", type=int, default=3, help="elements shown a block")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("axis_probe runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="axis_probe_")
    ctx = mp.start_processes(_rank, args=(2, tmp, args.kernel_impl), nprocs=2,
                             start_method="spawn", join=False)
    ref = {}
    want = _step(_cfg(args.kernel_impl), dev, ref)
    while not ctx.join(timeout=5):
        pass
    ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]
    print(json.dumps({"what": "split step against one process", "kernel_impl": args.kernel_impl,
                      "grad_rel": _global_rel(ranks[0]["grads"], want)}), flush=True)
    for name, rec in ref.items():
        if name == "hw":
            continue
        H, W = ref["hw"][name]
        g = rec["grad"].shape[0] // len(ROWS)  # groups; rank r holds the r-th half
        Hk, Wk = rec["grad"].shape[1:3]
        ref_pts = torch.stack(torch.meshgrid(
            (torch.arange(Hk, dtype=torch.float32) + 0.5) / max(Hk - 1.0, 1.0) * 2 - 1,
            (torch.arange(Wk, dtype=torch.float32) + 0.5) / max(Wk - 1.0, 1.0) * 2 - 1,
            indexing="ij"), -1)
        for r, rank in enumerate(ranks):
            mine = lambda t: t.reshape(len(ROWS), g, *t.shape[1:])[:, r * g // 2:(r + 1) * g // 2]
            got, exp = rank["record"][name]["grad"], mine(rec["grad"]).reshape(
                rank["record"][name]["grad"].shape)
            pos = (mine(rec["offset"]).reshape(got.shape) + ref_pts).clamp(-1, 1)
            row = {"block": name, "rank": r, "offset_grad_rel": _rel(got, exp), "top": []}
            for i in (got - exp).abs().flatten().argsort(descending=True)[:args.top].tolist():
                b, y, x, c = (int(v) for v in torch.unravel_index(torch.tensor(i), got.shape))
                px = (float(pos[b, y, x, c]) + 1) / 2 * ((H, W)[c] - 1)  # (y, x) order
                row["top"].append({"at": [b, y, x, c], "split": float(got[b, y, x, c]),
                                   "one_process": float(exp[b, y, x, c]), "pixel": px,
                                   "to_cell_edge": min(px % 1, 1 - px % 1)})
            print(json.dumps(row), flush=True)
    for eps in (1e-6, 1e-8):
        print(json.dumps({"what": "one process, image perturbed", "relative": eps,
                          "grad_rel": _global_rel(_step(_cfg(args.kernel_impl), dev,
                                                        perturb=eps), want)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
