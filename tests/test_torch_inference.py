"""The PyTorch port's SegInferencer (whole mode) against the JAX one
(slide mode, any size and ``predict``: ``tests/test_torch_eval.py``).

The JAX inferencer runs with ``exact=False`` (the image's sides are
multiples of 32, so no padding either way), float32 compute and float32
transfer, and upsamples the stride-4 logits on the host with cv2; the
port upsamples with ``F.interpolate(align_corners=False)``, the same
half-pixel bilinear rule. Float32 throughout, sums in another order:
1e-4 absolute on the logits.

The CUDA graphs' decision in plain Python (the capture and the replay are
``tests/test_torch_cuda.py``'s): never on the CPU, a key's second sighting
captured, a full cache evicting nothing, the key's shape, exactness and
model, and a model split over a mesh axis left eager.
"""

import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.eval.inference import SegInferencer as JaxSegInferencer
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
from dat_segmentation_tpu_torch.eval import inference
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


# -- CUDA graphs: the decision, on the CPU -------------------------------------


def test_forward_batch_on_the_cpu_never_captures(inferencers, monkeypatch):
    """On the CPU every call runs eagerly, with the model's own output: no
    graph is captured, and the cache is never consulted."""
    _, pinf, img = inferencers

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    batch = np.stack([img, img[::-1].copy()])
    valid = np.array([[64, 96], [50, 70]], np.int32)
    x = torch.as_tensor(batch)
    with torch.inference_mode():
        plain = pinf.model(x, upsample=False).float()
        exact = pinf.model(x, upsample=False, valid_hw=torch.as_tensor(valid)).float()
    for _ in range(3):
        assert torch.equal(pinf.forward_batch(batch), plain)
        assert torch.equal(pinf.forward_batch(batch, valid_hw=valid), exact)
    assert not pinf._graphs.graphs and not pinf._graphs.seen and not pinf._graphs.routes


@pytest.mark.parametrize("cap", [1, 2, inference.MAX_GRAPHS])
def test_a_key_is_captured_at_its_second_sighting(cap, monkeypatch):
    monkeypatch.setattr(inference, "MAX_GRAPHS", cap)
    graphs = inference.ForwardGraphs()
    assert graphs.route("a") == "eager"
    assert graphs.route("b") == "eager"
    assert graphs.route("a") == "capture"
    graphs.graphs["a"] = "graph a"
    assert [graphs.route("a") for _ in range(3)] == ["replay"] * 3
    assert graphs.route("b") == ("capture" if cap > 1 else "eager")
    assert graphs.routes == {"eager": 2 + (cap == 1), "capture": 1 + (cap > 1), "replay": 3}


@pytest.mark.parametrize("cap", [1, 3])
def test_a_full_cache_keeps_new_keys_eager_and_evicts_none(cap, monkeypatch):
    monkeypatch.setattr(inference, "MAX_GRAPHS", cap)
    graphs = inference.ForwardGraphs()
    for k in range(cap):
        assert [graphs.route(k), graphs.route(k)] == ["eager", "capture"]
        graphs.graphs[k] = f"graph {k}"
    for _ in range(4):
        assert graphs.route("new") == "eager"
    assert all(graphs.route(k) == "replay" for k in range(cap))
    assert sorted(graphs.graphs) == list(range(cap))
    assert graphs.routes == {"eager": cap + 4, "capture": cap, "replay": cap}


def test_the_key_holds_the_shape_the_exactness_and_the_model(inferencers, monkeypatch):
    """``forward_batch``'s keys, with the device decision and the capture
    faked on the CPU: one graph a shape, exactness and model, each captured
    at its second sighting and replayed after."""
    _, pinf, img = inferencers
    inf = SegInferencer(pinf.model, num_classes=8, compute_dtype=torch.float32, device="cpu")
    other = copy.deepcopy(inf.model)
    events = []
    monkeypatch.setattr(inference, "graphable", lambda device, model: True)
    monkeypatch.setattr(SegInferencer, "_capture",
                        lambda self, x, valid: events.append("capture") or
                        (tuple(x.shape), valid is not None, id(self.model)))
    monkeypatch.setattr(SegInferencer, "_replay",
                        staticmethod(lambda g, x, valid: events.append(g) or torch.zeros(1)))
    one, two = np.stack([img]), np.stack([img, img])
    valid = np.array([[64, 96]], np.int32)
    calls = [(one, None), (one, None), (one, valid), (two, None), (one, valid), (one, None)]
    for x, v in calls:
        inf.forward_batch(x, valid_hw=v)
    a, e = ((1, 64, 96, 3), False, id(inf.model)), ((1, 64, 96, 3), True, id(inf.model))
    assert events == ["capture", a, "capture", e, a]
    inf.model = other
    inf.forward_batch(one)
    inf.forward_batch(one)
    assert events[5:] == ["capture", ((1, 64, 96, 3), False, id(other))]
    assert len(inf._graphs.graphs) == 3


@pytest.mark.parametrize("device, split, want", [("cuda", False, True), ("cpu", False, False),
                                                 ("cuda", True, False)],
                         ids=["card", "cpu", "model-axis"])
def test_graphs_engage_on_the_card_outside_the_mesh(inferencers, device, split, want):
    _, pinf, _ = inferencers
    model = copy.deepcopy(pinf.model)
    if split:
        model.model_axis = object()  # as parallel/model_axis.py:shard_model_axis marks it
    assert inference.graphable(torch.device(device), model) is want


@pytest.mark.parametrize("hw", [(7, 9), (16, 16), (33, 44), (128, 176)])
def test_the_forwards_device_constants_equal_the_host_tensors_they_replace(hw):
    """What the forward now fills on the device (a CUDA graph cannot
    capture a host tensor's copy) holds the host tensors' values, bit for
    bit: the offset range, the exact rescale, ``query_coords``' divisor."""
    from dat_segmentation_tpu_torch.models.deformable_attention import _pair
    from dat_segmentation_tpu_torch.ops.deform_attn import query_coords

    H, W = hw
    assert torch.equal(_pair(1.0 / (H - 1.0), 1.0 / (W - 1.0), "cpu"),
                       torch.tensor([1.0 / (H - 1.0), 1.0 / (W - 1.0)]))
    assert torch.equal(_pair(max(H - 1.0, 1.0), max(W - 1.0, 1.0), "cpu"),
                       torch.tensor([max(H - 1.0, 1.0), max(W - 1.0, 1.0)]))
    for n, n_true in ((H, H), (W, W - 3)):
        idx = torch.arange(n, dtype=torch.float32)
        want = idx / torch.tensor(max(n_true - 1.0, 1.0)) * 2.0 - 1.0
        assert torch.equal(query_coords(n, n_true), want)
