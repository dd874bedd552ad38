"""Carry the JAX package's weights across to the port.

``convert_variables`` takes a ``dat_segmentation_tpu`` variable tree
(``{'params': ..., 'batch_stats': ...}``, leaves as numpy arrays or
anything ``np.asarray`` takes) and returns the port's ``state_dict``.
The port's modules carry the JAX module names (backbone, neck, the
UperNet, FCN and FPN heads alike), so a key is the JAX path joined with
dots and only the leaves change:

* conv ``kernel`` HWIO -> ``weight`` OIHW (a 1x1 conv (1, 1, in, out) ->
  (out, in, 1, 1), depthwise (k, k, 1, C) -> (C, 1, k, k)); dense
  ``kernel`` (in, out) -> ``nn.Linear`` ``weight`` (out, in);
* LayerNorm / BatchNorm ``scale`` -> ``weight``; ``bias``, ``gamma`` and
  ``rpe_table`` (continuous: (heads, 2*q_h-1, 2*q_w-1); ``fixed_pe``:
  (heads, q_h*q_w, kv_h*kv_w)) unchanged; the other position-bias modes'
  ``rpe_dwc`` (a depthwise conv) and ``cpb_fc1``/``cpb_fc2`` (dense) by
  the rules above;
* BatchNorm ``batch_stats`` ``mean``/``var`` -> ``running_mean`` /
  ``running_var``, with ``num_batches_tracked`` 0.

Load the result with ``model.load_state_dict(sd)``: its strict default
reports any key or shape the two trees do not share.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "gamma": "gamma", "rpe_table": "rpe_table"}
_STAT = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def convert_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables -> port state_dict (float32 tensors on the CPU)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables.get("params", {})):
        mod, name = ".".join(path[:-1]), path[-1]
        a = np.asarray(leaf, np.float32)
        if name == "kernel":
            key = f"{mod}.weight"
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        elif name in _LEAF:
            key = f"{mod}.{_LEAF[name]}" if mod else _LEAF[name]
        else:
            raise KeyError(f"no port counterpart for JAX parameter {'/'.join(path)}")
        sd[key] = torch.from_numpy(np.array(a))  # a writable copy
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        mod, name = ".".join(path[:-1]), path[-1]
        if name not in _STAT:
            raise KeyError(f"no port counterpart for JAX batch stat {'/'.join(path)}")
        sd[f"{mod}.{_STAT[name]}"] = torch.from_numpy(np.asarray(leaf, np.float32).copy())
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
