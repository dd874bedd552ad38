#!/usr/bin/env python3
"""Digests of the port's bf16 serving outputs on one CUDA card, to show two
trees of the port bit for bit equal.

    PYTHONPATH=<tree> python3 dat_segmentation_tpu_torch/tools/serve_digest.py

prints one JSON line: the SHA-256 of every K1 launch's output, in launch
order, in one ``SegInferencer`` batch of the flagship DAT-T++ SemanticFPN
(fpn_tiny_80k_dp04_lr2, random weights from seed 0, four 512x512 images
from seed 1, bf16), and of the batch's logits. Two trees whose serving
launches of K1 compute the same bits print the same digests. It exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_digest: no CUDA device", file=sys.stderr)
        return 1
    import dat_segmentation_tpu_torch as port
    from dat_segmentation_tpu_torch.ops import deform_attn as da

    launches = []
    kernel = da._fwd_kernel

    def recorded(*args, **kwargs):
        out = kernel(*args, **kwargs)
        launches.append(digest(out if isinstance(out, torch.Tensor) else out[0]))
        return out

    da._fwd_kernel = recorded
    cfg = port.get_config("fpn_tiny_80k_dp04_lr2").model
    torch.manual_seed(0)
    model = port.build_model(cfg, device="cuda")
    server = port.SegInferencer(model, num_classes=cfg.num_classes, device="cuda")
    images = np.random.RandomState(1).randn(4, 512, 512, 3).astype(np.float32)
    logits = server.forward_batch(images)
    torch.cuda.synchronize()
    print(json.dumps({"package": port.__file__, "card": torch.cuda.get_device_name(0),
                      "k1_launches": len(launches), "k1_outputs": launches,
                      "logits": digest(logits)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
