"""The JAX package's gradient on {"data": 2} against {"data": 2, "model": 2}.

A script, not a test: ``python tests/jax_model_axis_grads.py`` (from the
repository root, on the CPU with 8 virtual devices). It takes the tiny
UperNet of ``tests/test_torch_model_axis.py`` (``torch_parallel_worker.
tiny_seg``, drop 0) from the same random variables, and the same global
batch, and computes ``jax.grad`` of the segmentation loss under
``jax.jit`` with the parameters placed by ``state_shardings`` on each mesh
(replicated; ``fsdp='model'``). It prints each program's global norm and
every leaf whose gradient differs between the two by more than 1e-3 of its
norm, with the ratio of their norms.
"""

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch_parallel_worker as W  # noqa: E402
from dat_segmentation_tpu.configs import get_config  # noqa: E402
from dat_segmentation_tpu.models import build_model  # noqa: E402
from dat_segmentation_tpu.parallel import make_mesh  # noqa: E402
from dat_segmentation_tpu.parallel.mesh import shard_batch, state_shardings  # noqa: E402
from dat_segmentation_tpu.train.losses import segmentation_loss  # noqa: E402
from torch_port_helpers import random_variables  # noqa: E402


def main():
    model = build_model(W.tiny_seg(get_config, drop=0.0).model)
    variables = random_variables(model, np.zeros((1, 64, 64, 3), np.float32), seed=3, train=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    batch = W.seg_batches()[0]

    def loss(p, b):
        (logits, aux), _ = model.apply({"params": p, "batch_stats": stats}, b["image"],
                                       train=True, deterministic=True, mutable=["batch_stats"])
        return segmentation_loss(logits, aux, b["label"], aux_weight=0.4, ignore_index=255)

    grads = {}
    for name, shape, fsdp in (("data2", {"data": 2}, False),
                              ("data2_model2", {"data": 2, "model": 2}, "model")):
        mesh = make_mesh(shape, devices=jax.devices("cpu")[:int(np.prod(list(shape.values())))])
        sh = state_shardings(mesh, params, fsdp=bool(fsdp), axis=fsdp or "data")
        fn = jax.jit(lambda p, b: (lambda g: (g, optax.global_norm(g)))(jax.grad(loss)(p, b)),
                     in_shardings=(sh, None), out_shardings=(sh, NamedSharding(mesh, P())))
        with jax.sharding.use_abstract_mesh(mesh.abstract_mesh):
            g, norm = fn(jax.device_put(params, sh),
                         shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}))
        grads[name] = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(g)))
        print(f"{name}: global norm {float(norm):.6f}")
    for path, a in grads["data2"].items():
        b = grads["data2_model2"][path]
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if np.linalg.norm(np.asarray(b) - np.asarray(a)) > 1e-3 * na and na > 1e-6:
            print(f"{jax.tree_util.keystr(path)}: norm {na:.6g} -> {nb:.6g} (x{nb / na:.6f})")


if __name__ == "__main__":
    main()
