"""The PyTorch port's SegInferencer (whole mode) against the JAX one
(slide mode, any size and ``predict``: ``tests/test_torch_eval.py``).

The JAX inferencer runs with ``exact=False`` (the image's sides are
multiples of 32, so no padding either way), float32 compute and float32
transfer, and upsamples the stride-4 logits on the host with cv2; the
port upsamples with ``F.interpolate(align_corners=False)``, the same
half-pixel bilinear rule. Float32 throughout, sums in another order:
1e-4 absolute on the logits.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.eval.inference import SegInferencer as JaxSegInferencer
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
from torch_port_helpers import carry, random_variables, small_fpn

ATOL = 1e-4


@pytest.fixture(scope="module")
def inferencers():
    rng = np.random.RandomState(11)
    img = rng.randn(64, 96, 3).astype(np.float32)
    jmodel = jax_build_model(small_fpn(jax_get_config))
    variables = random_variables(jmodel, img[None], seed=4, train=False)
    jinf = JaxSegInferencer(
        jmodel, variables, num_classes=8, exact=False,
        compute_dtype=jnp.float32, transfer_dtype=jnp.float32,
    )
    torch.manual_seed(0)
    pmodel = carry(build_model(small_fpn(get_config), device="cpu"), variables)
    pinf = SegInferencer(pmodel, num_classes=8, compute_dtype=torch.float32, device="cpu")
    return jinf, pinf, img


def test_logits_whole_matches_jax(inferencers):
    jinf, pinf, img = inferencers
    ref = jinf.logits_whole(img)
    got = pinf.logits_whole(img)
    assert got.shape == ref.shape == (64, 96, 8)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_forward_batch_matches_jax(inferencers):
    jinf, pinf, img = inferencers
    batch = np.stack([img, img[::-1].copy()])
    ref = jinf.forward_batch(batch)
    got = pinf.forward_batch(batch)
    assert got.shape == ref.shape == (2, 16, 24, 8)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_inferencer_needs_cuda_unless_cpu_is_asked(inferencers, monkeypatch):
    _, pinf, _ = inferencers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegInferencer(pinf.model)
