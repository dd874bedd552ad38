"""Shared by the PyTorch port's tests (tests/test_torch_*.py).

A small SemanticFPN, a small UperNet and a small classifier configuration
built the same way in both packages, their 'D' blocks in any position-bias
mode (``with_modes``),
random variables for a JAX module made from a numpy seed, and the same
weights carried into a port module through ``utils/convert.py``. JAX is
imported only where it is used: ``tests/test_torch_cuda.py`` runs on a
machine without it.
"""

import dataclasses
import functools
import re

import numpy as np
import torch

from dat_segmentation_tpu_torch.utils.convert import convert_variables

# The suite runs in several pytest-xdist workers on one machine; torch's
# default intra-op pool, a thread a core in each worker, oversubscribes its
# cores. Two threads a worker (the port's test files that do not import
# this module set the same).
torch.set_num_threads(2)


def small_fpn(get_config, head_width=16, num_classes=8):
    """fpn_tiny_80k_dp04_lr2 cut to a few narrow blocks, with a 'D' block in
    every stage, heads ``head_width`` wide and ``num_classes`` classes, from
    either package's ``get_config``. (The CUDA kernel takes head width 32,
    as every preset.)"""
    cfg = get_config("fpn_tiny_80k_dp04_lr2").model
    hw = head_width
    bb = dataclasses.replace(
        cfg.backbone,
        dim_stem=2 * hw,
        dims=(2 * hw, 2 * hw, 4 * hw, 4 * hw),
        depths=(1, 2, 1, 1),
        heads=(2, 2, 4, 4),
        groups=(1, 1, 2, 2),
        stage_spec=(("D",), ("X", "D"), ("D",), ("D",)),
    )
    return dataclasses.replace(
        cfg,
        backbone=bb,
        neck=dataclasses.replace(cfg.neck, out_channels=32),
        decode_head=dataclasses.replace(cfg.decode_head, channels=16, num_classes=num_classes),
        num_classes=num_classes,
    )


def small_upernet(get_config, head_width=16, num_classes=8, drop=0.0, topdown="mmseg"):
    """upn_tiny_160k_dp03_lr6 cut to depths (1, 2, 1, 1) and narrow widths,
    with a 'D' block in every stage, ``num_classes`` classes, drop path
    and both heads' dropout at ``drop``, from either package's
    ``get_config``; returns the ModelConfig."""
    cfg = get_config("upn_tiny_160k_dp03_lr6").model
    hw = head_width
    bb = dataclasses.replace(
        cfg.backbone,
        dim_stem=2 * hw,
        dims=(2 * hw, 2 * hw, 4 * hw, 4 * hw),
        depths=(1, 2, 1, 1),
        heads=(2, 2, 4, 4),
        groups=(1, 1, 2, 2),
        stage_spec=(("D",), ("X", "D"), ("D",), ("D",)),
        drop_path_rate=drop,
    )
    return dataclasses.replace(
        cfg,
        backbone=bb,
        decode_head=dataclasses.replace(
            cfg.decode_head, channels=32, num_classes=num_classes,
            kwargs={"dropout_ratio": drop, "topdown": topdown},
        ),
        auxiliary_head=dataclasses.replace(
            cfg.auxiliary_head, channels=16, num_classes=num_classes,
            kwargs={"dropout_ratio": drop},
        ),
        num_classes=num_classes,
    )


def small_classifier(get_config, head_width=16, num_classes=10):
    """cls_tiny_imagenet at depths (1, 2, 1, 1), heads ``head_width`` wide
    (dims 32-64 at 16), a 'D' block in every stage, drop path 0 and
    ``num_classes`` classes, from either package's ``get_config``; returns
    the ModelConfig. (The CUDA kernel takes head width 32, as every
    preset.)"""
    cfg = get_config("cls_tiny_imagenet").model
    hw = head_width
    bb = dataclasses.replace(
        cfg.backbone, dim_stem=2 * hw, dims=(2 * hw, 2 * hw, 4 * hw, 4 * hw), depths=(1, 2, 1, 1),
        heads=(2, 2, 4, 4), groups=(1, 1, 2, 2),
        stage_spec=(("D",), ("X", "D"), ("D",), ("D",)), drop_path_rate=0.0,
    )
    return dataclasses.replace(
        cfg, backbone=bb, num_classes=num_classes,
        decode_head=dataclasses.replace(cfg.decode_head, num_classes=num_classes),
    )


_MODE_FLAGS = {"dwc_pe": "dwc_pes", "fixed_pe": "fixed_pes", "log_cpb": "log_cpb",
               "no_off": "no_offs"}


def with_modes(model_cfg, modes):
    """``model_cfg`` with stage i's 'D' blocks in the position-bias mode
    ``modes[i]``: ``'continuous'`` (the presets'), ``'dwc_pe'``,
    ``'fixed_pe'``, ``'log_cpb'``, ``'no_off'`` or ``'no_pe'``; either
    package's config."""
    kw = {field: tuple(m == mode for m in modes) for mode, field in _MODE_FLAGS.items()}
    kw["use_pes"] = tuple(m != "no_pe" for m in modes)
    return dataclasses.replace(model_cfg, backbone=dataclasses.replace(model_cfg.backbone, **kw))


def random_variables(module, *args, seed=0, **kwargs):
    """Variables of ``module`` on ``args`` drawn from a numpy seed: kernels
    at the torch default scale, scales near 1, biases, tables and running
    means near 0, variances in [0.5, 1.5]. Only the tree's shapes come from
    ``module.init`` (traced, not run: eager init is slow on the CPU)."""
    import jax

    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs), *args
    )
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ("scale", "gamma"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:  # bias, mean, rpe_table
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def carry(port_module, variables):
    """Load the JAX variables into ``port_module`` (strict) and return it."""
    port_module.load_state_dict(convert_variables(variables))
    return port_module.eval()


def jax_apply(module, variables, *args, **kwargs):
    """``module.apply`` under jit (one compile beats eager op-by-op dispatch
    on the CPU by seconds)."""
    import jax
    import jax.numpy as jnp

    fn = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))
    return fn(jax.tree_util.tree_map(jnp.asarray, variables), *(jnp.asarray(a) for a in args))


def port_apply(module, *args, **kwargs):
    with torch.no_grad():
        return module(*(torch.from_numpy(np.asarray(a)) for a in args), **kwargs)


class ShapeInit:
    """A JAX model whose ``init`` gives zeros of the variables' shapes
    (traced, not compiled: eager init compiles op by op for half a
    minute here). The JAX test CLI overwrites every one of them with the
    checkpoint (its report: nothing missing)."""

    def __init__(self, model):
        self._model = model

    def init(self, *args, **kwargs):
        import jax
        import jax.numpy as jnp

        shapes = jax.eval_shape(functools.partial(self._model.init, **kwargs), *args)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    def __getattr__(self, name):
        return getattr(self._model, name)


def jax_reference_keys(state):
    """mmseg's FPNHead keys as the JAX converter reads them
    (tests/test_torch_checkpoint.py: ``scale_heads.{i}.{2k}`` there,
    ``.{k}`` here)."""
    def rename(key):
        m = re.match(r"decode_head\.scale_heads\.(\d+)\.(\d+)\.(.*)", key)
        return key if m is None else (
            f"decode_head.scale_heads.{m.group(1)}.{int(m.group(2)) // 2}.{m.group(3)}")

    return {rename(k): v for k, v in state.items()}
