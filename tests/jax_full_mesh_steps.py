"""The JAX package's train step on meshes with a model and a spatial axis.

A script, not a test: ``python tests/jax_full_mesh_steps.py`` (from the
repository root, on the CPU with 8 virtual devices; a few minutes). It takes
the tiny UperNet of ``tests/test_torch_full_mesh.py`` (``torch_parallel_worker.
tiny_seg``, drop 0, float32) from the same random variables and one step on
``seg_batches()[0]`` (4 x 64²) on each mesh below, its state placed by
``shard_state`` with the row's fsdp, and prints the loss, the global
gradient norm and the largest parameter difference from the one-device step.
On the CPU's partitioner the norm departs from the one-device norm on every
mesh with both a model and a spatial axis above 1 (ROADMAP.md, Queue 3).
"""

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch_parallel_worker as W  # noqa: E402
from dat_segmentation_tpu.configs import get_config  # noqa: E402
from dat_segmentation_tpu.models import build_model  # noqa: E402
from test_torch_full_mesh import _jax_step  # noqa: E402
from torch_port_helpers import random_variables  # noqa: E402

MESHES = (({"data": 1}, False), ({"data": 1, "model": 2}, False),
          ({"data": 2, "spatial": 2}, "spatial"),
          ({"data": 1, "model": 2, "spatial": 2}, False),
          ({"data": 1, "model": 2, "spatial": 2}, "model"),
          ({"data": 1, "model": 2, "spatial": 2}, "spatial"),
          ({"data": 2, "model": 2, "spatial": 2}, "data"),
          ({"data": 2, "model": 2, "spatial": 2}, "model"))


def main():
    variables = random_variables(build_model(W.tiny_seg(get_config, drop=0.0).model),
                                 np.zeros((1, 64, 64, 3), np.float32), seed=3, train=False)
    batch = W.seg_batches()[0]
    one = None
    print("| mesh | fsdp | loss | grad_norm | max |dparam| vs one device |")
    for shape, fsdp in MESHES:
        metrics, state = _jax_step(variables, batch, shape, fsdp)
        one = one or state
        diff = max(float((state[k] - one[k]).abs().max()) for k in one
                   if not k.endswith("num_batches_tracked"))
        print(f"| {shape} | {fsdp!r} | {float(metrics['loss']):.7f} | "
              f"{float(metrics['grad_norm']):.6f} | {diff:.3g} |", flush=True)


if __name__ == "__main__":
    main()
