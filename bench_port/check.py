"""The correctness check's side of a run: the reference built from the
configuration file and the seed's weights, and the numbers that compare the
program's outputs with the reference's.

Serving: ``logit_rel_l2``, the largest over the sampled images of
||program - reference|| / ||reference|| over the image's stride-4 logits.

Training, a leaf's gap: |norm - reference norm| over the larger of the
reference leaf's norm and the median leaf's, of the first step's gradient
and of the parameters' change over the checked steps. A leaf whose
reference gradient is under a thousandth of the median leaf's (a key's bias
under the softmax) moves under AdamW by round-off alone: its change is not
taken. Compared: ``first_loss_gap`` (|loss - reference loss| / |reference
loss| of the first step), ``grad_gap_median`` and ``change_gap_median`` (the
median leaf's gaps). Read and printed, not compared (PERF.md §2 gives why):
``loss_gap`` (the largest over the checked steps), ``grad_gap_worst`` and
``change_gap_worst`` (the worst leaf's, always one of the offset nets',
whose gradient jumps as a sampled position crosses a pixel: the float32
reference moved by a rounding of its inputs reads 0.1-0.27 there).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .reference.model import Segmentor
from .weights import make_weights

NOUGHT_GRAD = 1e-3  # of the median leaf's gradient norm: a leaf that moves by round-off


def reference_shapes(config: dict) -> Dict[str, torch.Size]:
    with torch.device("meta"):
        model = Segmentor(config["train_config"]["model"])
    return {k: v.shape for k, v in model.state_dict().items()}


def reference_model(config: dict, device, weights_seed: int,
                    round_to: Optional[torch.dtype]) -> Segmentor:
    """The reference of ``config`` on ``device`` with the seed's weights."""
    with torch.device("meta"):
        model = Segmentor(config["train_config"]["model"])
    model = model.to_empty(device=device)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict(make_weights(shapes, weights_seed, device, round_to))
    return model


def exact_float32() -> None:
    """float32 products as float32 (no TF32) for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _leaf_gaps(prog: dict, ref: dict):
    """Each leaf's gradient gap, and the change gap of each leaf that moves
    by more than round-off (with that mask)."""
    gp, gr = np.asarray(prog["grad"]), np.asarray(ref["grad"])
    cp, cr = np.asarray(prog["change"]), np.asarray(ref["change"])
    gmed = float(np.median(gr))
    moved = gr >= NOUGHT_GRAD * gmed
    cmed = float(np.median(cr[moved]))
    grad = np.abs(gp - gr) / np.maximum(gr, gmed)
    change = np.where(moved, np.abs(cp - cr) / np.maximum(cr, cmed), 0.0)
    return grad, change, moved


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the program's readings ``prog`` (losses, first gradient
    and change norms a leaf) against the reference's ``ref``
    (``reference.train.run_steps``); the module's docstring says which are
    compared."""
    grad, change, moved = _leaf_gaps(prog, ref)
    lr = np.asarray(ref["losses"])
    loss = np.abs(np.asarray(prog["losses"]) - lr) / np.abs(lr)
    return {
        "first_loss_gap": float(loss[0]),
        "grad_gap_median": float(np.median(grad)),
        "change_gap_median": float(np.median(change[moved])),
        "loss_gap": float(np.max(loss)),
        "grad_gap_worst": float(np.max(grad)),
        "change_gap_worst": float(np.max(change)),
    }


def worst_leaves(prog: dict, ref: dict, k: int = 5) -> Dict[str, list]:
    """The ``k`` leaves of the largest gradient and change gaps: (name,
    reference norm, program norm, gap), for a look at what a gap is made of."""
    grad, change, _ = _leaf_gaps(prog, ref)
    names = ref["names"]

    def top(gaps, key):
        return [(names[i], float(ref[key][i]), float(prog[key][i]), float(gaps[i]))
                for i in np.argsort(-gaps)[:k]]

    return {"grad": top(grad, "grad"), "change": top(change, "change")}
