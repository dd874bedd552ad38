"""ops/interpolate.py and ops/grid_sample.py of the PyTorch port against
the JAX package, float32 on the CPU. The JAX package computes resizes as
matmuls and the K/V sampler as tap-weight products; the port calls the
PyTorch functionals. Same arithmetic up to the order of float32 sums, so
1e-5 absolute on values of order 1."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dat_segmentation_tpu.models.deformable_attention import (
    reference_points as jax_reference_points,
)
from dat_segmentation_tpu.ops.grid_sample import (
    grid_sample as jax_grid_sample,
    grid_sample_points_mxu,
    lerp_weight_matrix as jax_lerp_weight_matrix,
)
from dat_segmentation_tpu.ops import interpolate as jint
from dat_segmentation_tpu_torch.models.deformable_attention import reference_points
from dat_segmentation_tpu_torch.ops import grid_sample as tgs
from dat_segmentation_tpu_torch.ops import interpolate as tint

ATOL = 1e-5
torch.set_num_threads(2)  # as tests/torch_port_helpers.py: one of several xdist workers


def _x(shape=(2, 6, 10, 5), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(12, 20), (3, 7), (6, 10), (13, 4)])
def test_resize_bilinear(out_hw, align_corners):
    x = _x()
    ref = jint.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align_corners)
    got = tint.resize_bilinear(torch.from_numpy(x), out_hw, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("out_hw", [(12, 20), (24, 40), (6, 10)])
def test_resize_nearest(out_hw):
    x = _x()
    ref = jint.resize_nearest(jnp.asarray(x), out_hw)
    got = tint.resize_nearest(torch.from_numpy(x), out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("out_hw", [(1, 1), (2, 3), (6, 6)])
def test_adaptive_avg_pool(out_hw):
    x = _x(seed=1)
    ref = jint.adaptive_avg_pool(jnp.asarray(x), out_hw)
    got = tint.adaptive_avg_pool(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_avg_pool():
    x = _x(seed=2)
    ref = jint.avg_pool(jnp.asarray(x), 2, 2)
    got = tint.avg_pool(torch.from_numpy(x), 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("grid_range", [1.0, 1.3])
def test_grid_sample_matches_jax_gather_and_tap_matmuls(grid_range):
    """F.grid_sample against both JAX samplers: the gather form and the
    tap-weight matmul form the JAX module uses (points in (y, x) order)."""
    rng = np.random.RandomState(3)
    x = rng.randn(3, 9, 11, 4).astype(np.float32)
    pts_yx = rng.uniform(-grid_range, grid_range, (3, 5, 7, 2)).astype(np.float32)
    grid_xy = pts_yx[..., ::-1].copy()
    got = tgs.grid_sample(torch.from_numpy(x), torch.from_numpy(grid_xy)).numpy()
    ref = jax_grid_sample(jnp.asarray(x), jnp.asarray(grid_xy), align_corners=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    mxu = grid_sample_points_mxu(jnp.asarray(x), jnp.asarray(pts_yx.reshape(3, 35, 2)))
    np.testing.assert_allclose(got.reshape(3, 35, 4), np.asarray(mxu), rtol=0, atol=ATOL)


def test_grid_sample_bf16_keeps_float32_coordinates():
    rng = np.random.RandomState(4)
    x = rng.randn(1, 128, 128, 2).astype(np.float32)
    grid = rng.uniform(-1, 1, (1, 4, 4, 2)).astype(np.float32)
    full = tgs.grid_sample(torch.from_numpy(x), torch.from_numpy(grid))
    half = tgs.grid_sample(torch.from_numpy(x).bfloat16(), torch.from_numpy(grid))
    assert half.dtype == torch.bfloat16
    # only the bf16 rounding of x and of the result; the grid stays exact
    np.testing.assert_allclose(half.float().numpy(), full.numpy(), rtol=0, atol=0.05)


def test_lerp_weight_matrix():
    coords = np.array([[-1.5, -0.25, 0.0, 2.5, 3.999, 4.0, 7.2]], np.float32)
    ref = jax_lerp_weight_matrix(jnp.asarray(coords), 5)
    got = tgs.lerp_weight_matrix(torch.from_numpy(coords), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-7)


@pytest.mark.parametrize("hw", [(2, 2), (4, 7), (16, 16)])
def test_reference_points(hw):
    ref = jax_reference_points(*hw)
    got = reference_points(*hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-7)
