"""Weights and inputs made from the seed, on the device, in a few large calls.

``make_weights`` fills every parameter and buffer of the reference model's
``state_dict`` (the program's names) from one ``torch.rand`` of all their
elements together on the device's generator: a matrix or convolution kernel
uniform in ±1/sqrt(fan in) (PyTorch's default), its bias likewise, a norm's
scale 1 and shift 0, a position-bias table uniform in ±0.02, BatchNorm's
running statistics 0 and 1. The same seed gives the same tensors on any call,
so the program and the reference, each handed a copy, start from one model.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:])) if len(shape) > 1 else 1


def make_weights(shapes: Dict[str, torch.Size], seed: int, device,
                 round_to: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``shapes`` (a ``state_dict``'s names and
    shapes, float leaves and integer counters); float leaves float32, rounded
    to ``round_to`` first where given (the dtype they are served in)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    floats = [n for n in shapes if not n.endswith("num_batches_tracked")]
    total = sum(int(math.prod(shapes[n])) for n in floats)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out, at = {}, 0
    for name in shapes:
        shape = tuple(shapes[name])
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        n = int(math.prod(shape))
        u = flat[at:at + n].view(shape)
        at += n
        parent, leaf = name.rsplit(".", 1)
        sibling = tuple(shapes.get(f"{parent}.weight", ()))
        if leaf == "running_mean":
            t = torch.zeros_like(u)
        elif leaf == "running_var":
            t = torch.ones_like(u)
        elif leaf == "rpe_table":
            t = u * 0.02
        elif len(sibling) == 1 and leaf in ("weight", "bias"):  # a norm's scale and shift
            t = torch.ones_like(u) if leaf == "weight" else torch.zeros_like(u)
        elif leaf in ("weight", "bias") and len(sibling) > 1:
            t = u / math.sqrt(_fan_in(sibling))
        else:
            raise ValueError(f"no rule makes {name} {shape}")
        out[name] = t.to(round_to).float() if round_to is not None else t.contiguous()
    return out


def normal_images(n: int, h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` normalised (h, w, 3) images, N(0, 1), rounded to bf16 values (the
    dtype the program computes in) and held in float32."""
    x = torch.randn(n, h, w, 3, generator=gen, device=device, dtype=torch.float32)
    return x.to(torch.bfloat16).float()
