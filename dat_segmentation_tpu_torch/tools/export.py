"""Export CLI of the port: a config and a checkpoint -> a serving artifact.

    python -m dat_segmentation_tpu_torch.tools.export fpn_tiny_80k_dp04_lr2 CKPT \\
        --output art/ --shapes 512x512,512x704 [--check]
    python -m dat_segmentation_tpu_torch.tools.export cls_tiny_imagenet CKPT --task cls \\
        --output art_cls/ --shapes 224x224 --batch 64

The port's ``tools/export.py`` (the JAX package's, with its arguments).
``CKPT`` is a reference ``.pth`` (converted on load), a ``ckpt_*``
directory of the port's trainer or of ``tools/convert.py``, or ``random``
for a smoke export with the weights a seed-0 build gives. The artifact
directory (one ``torch.export`` entry a shape, ``meta.json`` and, for the
card, the kernels' ``sm_90a`` libraries in ``kernels/``) loads with
``dat_segmentation_tpu_torch.serving.ServingModel``, without the model
code and without ``nvcc`` (``serving/export.py``). ``--check`` reloads
the artifact and holds each entry to the live model on the same seeded input (relative error under
1e-3; the segmentor's live model is ``SegInferencer.forward_batch``).
``--no-portable`` keeps the config's ``kernel_impl`` (``'pallas'``: K3 in
the graph); the default exports the unfused chain, as the JAX package
does. ``--device`` is the card unless named: an entry runs on the device
it was exported on. The JAX CLI's ``--platforms`` names that device too,
as one platform: ``cpu``, or ``cuda`` (``gpu`` an alias), agreeing with
``--device`` where both are given. ``torch.export`` bakes the device into
the graph, so an artifact has one device, as each entry has one static
shape; ``tpu`` and a list of platforms are refused. ``main(argv)``
returns a summary (entries, bytes, export seconds, check errors).
"""

from __future__ import annotations

import argparse
import copy
import time
from typing import Optional, Sequence


_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}  # --platforms -> the torch device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DAT serving export (PyTorch port)")
    p.add_argument("config", help="preset name or python config file")
    p.add_argument("checkpoint", help="reference torch .pth, a ckpt_* directory, or 'random'")
    p.add_argument("--output", required=True, help="artifact directory")
    p.add_argument("--task", default="seg", choices=["seg", "cls"])
    p.add_argument("--shapes", default="512x512",
                   help="comma list of HxW entries, e.g. 512x512,512x704")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--no-portable", action="store_true",
                   help="keep the config's kernel_impl ('pallas': K3 in the graph)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and compare with the live model")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--platforms", default=None,
                   help="the JAX CLI's flag, as one platform: cpu, or cuda (gpu); "
                        "sets --device, and must agree with it")
    args = p.parse_args(argv)
    if args.platforms is not None:
        names = [n.strip().lower() for n in args.platforms.split(",") if n.strip()]
        if len(names) != 1 or names[0] not in _PLATFORMS:
            p.error(f"--platforms {args.platforms}: one of {', '.join(_PLATFORMS)}; "
                    "torch.export bakes one device into each artifact's graphs")
        device = _PLATFORMS[names[0]]
        if args.device is not None and args.device.split(":")[0] != device:
            p.error(f"--platforms {args.platforms} and --device {args.device} disagree")
        args.device = args.device or device
    return args


def _shapes(text: str):
    return [tuple(int(v) for v in tok.lower().split("x")) for tok in text.split(",")]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..data.ade20k import ADE20K_CLASSES, ADE20K_NUM_CLASSES, ADE20K_PALETTE
    from ..eval.inference import SegInferencer
    from ..models.builder import build_model
    from ..serving import ServingModel, export_classifier, export_segmentor, save_artifact
    from ..train.checkpoint import load_pretrained, merge_pretrained
    from ..utils.device import resolve_device
    from .train import apply_overrides, load_config

    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.set)
    torch.manual_seed(0)  # 'random', and keys a checkpoint lacks, get this init
    model = build_model(cfg.model, device=device)
    if args.checkpoint != "random":
        kind = "classifier" if args.task == "cls" else "segmentor"
        state = load_pretrained(args.checkpoint, cfg.model, kind=kind)
        _, report = merge_pretrained(model, state, return_report=True)
        print(f"[load] {args.checkpoint}: {len(state)} tensors; "
              + ", ".join(f"{k} {len(v)}" for k, v in report.items()))
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    export_fn = export_classifier if args.task == "cls" else export_segmentor
    shapes = _shapes(args.shapes)
    entries, export_s = {}, {}
    for h, w in shapes:
        name = f"{args.task}_{h}x{w}_b{args.batch}"
        print(f"exporting {name} ...")
        t0 = time.perf_counter()
        entries[name] = export_fn(cfg.model, model.state_dict(), batch=args.batch,
                                  input_size=(h, w), compute_dtype=dtype, device=device,
                                  portable=not args.no_portable)
        export_s[name] = time.perf_counter() - t0
    meta_kwargs = {}
    if args.task == "seg" and cfg.model.num_classes == ADE20K_NUM_CLASSES:
        meta_kwargs = {"classes": ADE20K_CLASSES, "palette": ADE20K_PALETTE}
    out = save_artifact(args.output, entries,
                        task="segmentor" if args.task == "seg" else "classifier",
                        model_cfg=cfg.model, num_classes=cfg.model.num_classes, **meta_kwargs)
    srv = ServingModel.load(out)
    total = sum(e["bytes"] for e in srv.entries.values())
    libs = srv.meta.get("kernel_libraries", [])
    print(f"wrote {out} ({len(entries)} entries, {total / 1e6:.1f} MB; "
          f"{len(libs)} kernel libraries, {sum(lib['bytes'] for lib in libs) / 1e6:.1f} MB)")
    summary = {"output": str(out), "entries": {
        name: {"bytes": srv.entries[name]["bytes"], "export_s": export_s[name],
               "kernels": srv.entries[name]["kernels"], "device": srv.entries[name]["device"]}
        for name in entries}}
    if args.check:
        if args.task == "seg":
            live = SegInferencer(model, num_classes=cfg.model.num_classes, compute_dtype=dtype,
                                 device=device).forward_batch
        else:
            cast = copy.deepcopy(model).to(dtype=dtype).eval()

            def live(x):
                with torch.inference_mode():
                    return cast(torch.as_tensor(x).to(device, dtype)).float()
        rng = np.random.RandomState(0)
        for (h, w), name in zip(shapes, entries):
            x = rng.randn(args.batch, h, w, 3).astype(np.float32)
            got, want = srv(name, x), live(x)
            err = float((got - want).abs().max())
            rel = err / (float(want.abs().max()) + 1e-9)
            equal = bool(torch.equal(got, want))
            print(f"check {name}: max|artifact - live| = {err:.3e} (rel {rel:.3e}, "
                  f"bit-equal {equal})")
            summary["entries"][name].update(check_rel=rel, check_equal=equal)
            if not rel < 1e-3:
                raise RuntimeError(f"check {name}: artifact and live model differ, rel {rel:.3e}")
        print("check OK")
    return summary


if __name__ == "__main__":
    main()
