"""AdamW with no-decay parameter groups, in PyTorch.

Counterpart of ``dat_segmentation_tpu/train/optim.py``: a parameter skips
weight decay **iff** one of the no-decay keys is a substring of its dotted
name (case-insensitive), nothing else. The port's names are the JAX
package's (joined with '.' instead of '/'), so the key list carries over
as it is, and its consequences with it: projection and conv biases and
the heads' BatchNorm parameters **are** decayed; every LayerNorm is not.
Decay is decoupled (``torch.optim.AdamW``), eps 1e-8, as optax's
``adamw``. Optional global-norm clipping (``clip_by_global_norm``) is
applied by the train step before the update.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn


def no_decay_names(model: nn.Module, keys: Sequence[str]) -> List[str]:
    """Names of the parameters that skip weight decay."""
    lowered = [k.lower() for k in keys]
    return [n for n, _ in model.named_parameters() if any(k in n.lower() for k in lowered)]


def make_optimizer(
    model: nn.Module,
    *,
    lr: float,
    betas: Tuple[float, float] = (0.9, 0.999),
    weight_decay: float = 0.01,
    no_decay_keys: Sequence[str] = (),
) -> torch.optim.AdamW:
    """AdamW over two groups: decayed, and the no-decay names at 0."""
    skip = set(no_decay_names(model, no_decay_keys))
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if n not in skip], "weight_decay": weight_decay},
        {"params": [p for n, p in named if n in skip], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=1e-8)
