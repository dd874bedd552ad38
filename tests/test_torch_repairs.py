"""Repairs of the PyTorch port against the reference's behaviour, on the CPU.

* ``SegInferencer`` runs a cast copy and leaves the caller's model as it
  is (the JAX one casts a copy of the variables).
* ``use_checkpoint`` recomputes each backbone stage in the backward, as the
  JAX package's ``nn.remat`` does; drop path and dropout draw from a
  caller-owned generator, which ``torch.utils.checkpoint`` does not
  restore, so the port replays it, and the BatchNorms inside a stage move
  their statistics in the forward only: the checkpointed step equals the
  plain one (1e-6 relative; on the CPU they agree bit for bit), also with
  attention dropout.
* The TTA resize of a uint8 image is cv2's fixed-point ``INTER_LINEAR``,
  bit for bit (its JAX-package counterpart is in ``test_torch_eval.py``).
* K1's plain version gives each query's log-sum-exp of its scores (K2
  takes P from it on the card), and the query coordinates divide exactly.
"""

import copy
import dataclasses

import cv2
import numpy as np
import pytest
import torch

from dat_segmentation_tpu_torch import (
    SegInferencer,
    build_model,
    create_train_state,
    get_config,
    make_train_step,
)
from dat_segmentation_tpu_torch.ops import deform_attn as da
from dat_segmentation_tpu_torch.ops.interpolate import resize_uint8_linear
from torch_port_helpers import small_fpn, small_upernet

STEP_RTOL = 1e-6


def test_inferencer_leaves_callers_model_alone():
    torch.manual_seed(0)
    model = build_model(small_fpn(get_config), device="cpu")
    before = {n: t.clone() for n, t in model.state_dict().items()}
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    inf = SegInferencer(model, num_classes=8, compute_dtype=torch.bfloat16, device="cpu")
    got = inf.forward_batch(x)
    for name, t in model.state_dict().items():
        assert t.dtype == before[name].dtype and torch.equal(t, before[name]), name
    assert next(inf.model.parameters()).dtype == torch.bfloat16
    # the logits are those of the model cast in place, as before the repair
    cast = copy.deepcopy(model).to(torch.bfloat16).eval()
    with torch.inference_mode():
        ref = cast(torch.from_numpy(x).to(torch.bfloat16), upsample=False).float()
    assert torch.equal(got, ref)


def _train(use_checkpoint, dtype, cmt=False, attn_drop=0.0, steps=2):
    """``steps`` steps of the small UperNet with drop path and dropout 0.2
    from one seed: the metrics, the gradients, the BN buffers and how
    often each backbone stage ran forward. ``cmt``: stages 2 and 3 take
    the CMT MLP, whose BatchNorms move their statistics in the stage;
    ``attn_drop``: attention dropout, whose blocks run the composite."""
    cfg = get_config("upn_tiny_160k_dp03_lr6")
    mc = small_upernet(get_config, drop=0.2)
    mc = dataclasses.replace(mc, backbone=dataclasses.replace(
        mc.backbone, use_checkpoint=use_checkpoint, attn_drop_rate=attn_drop,
        use_cmt_mlps=(False, False, True, True) if cmt else mc.backbone.use_cmt_mlps))
    cfg = dataclasses.replace(cfg, model=mc,
                              schedule=dataclasses.replace(cfg.schedule, warmup_iters=0))
    torch.manual_seed(0)
    model = build_model(mc, device="cpu")
    runs = [0]
    for i in range(4):
        getattr(model.backbone, f"stage_{i}").register_forward_pre_hook(
            lambda m, a: runs.__setitem__(0, runs[0] + 1))
    state = create_train_state(model, cfg)
    step = make_train_step(model, num_classes=8, compute_dtype=dtype)
    rng = np.random.RandomState(3)
    out = []
    for _ in range(steps):
        label = rng.randint(0, 8, (2, 64, 64))
        label[:, :4] = 255
        batch = {"image": rng.randn(2, 64, 64, 3).astype(np.float32), "label": label}
        _, metrics = step(state, batch)
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        out.append((metrics, grads))
    buffers = {n: b.clone() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    return out, buffers, runs[0]


@pytest.mark.parametrize("dtype,cmt,attn_drop", [
    (torch.float32, False, 0.0), (torch.bfloat16, False, 0.0), (torch.float32, True, 0.0),
    (torch.float32, False, 0.2)], ids=["f32", "bf16", "f32-cmt", "f32-attn-drop"])
def test_checkpointed_step_equals_plain_step(dtype, cmt, attn_drop):
    """Loss, every gradient and the BN statistics of two steps with drop
    path and dropout on; in bf16 the recompute must see the step's bf16
    casts of the weights, not the float32 masters; with BatchNorms inside
    the stages the recompute must not move their statistics again; with
    attention dropout the recompute must draw the forward's masks."""
    plain, plain_bn, plain_runs = _train(False, dtype, cmt, attn_drop)
    ckpt, ckpt_bn, ckpt_runs = _train(True, dtype, cmt, attn_drop)
    assert ckpt_runs == 2 * plain_runs == 2 * 4 * 2  # each stage again in the backward
    for (pm, pg), (cm, cg) in zip(plain, ckpt):
        for key in ("loss", "grad_norm"):
            torch.testing.assert_close(cm[key], pm[key], rtol=STEP_RTOL, atol=0)
        assert cg.keys() == pg.keys()
        for name in pg:
            torch.testing.assert_close(cg[name], pg[name], rtol=STEP_RTOL,
                                       atol=STEP_RTOL * pg[name].abs().max().item(), msg=name)
    for name in plain_bn:
        torch.testing.assert_close(ckpt_bn[name], plain_bn[name], rtol=STEP_RTOL, atol=0,
                                   msg=name)


@pytest.mark.parametrize(
    "src,dst",
    [
        ((100, 140), (64, 90)),      # MS ratio 0.5 of the eval tests' image
        ((100, 140), (224, 314)),    # ratio 1.75: upsampling
        ((512, 683), (384, 512)),    # 0.75 of the smoke test's raw image
        ((512, 683), (896, 1195)),   # 1.75
        ((333, 517), (166, 258)),    # near-halving
        ((64, 64), (32, 32)),        # exact halving (cv2's area shortcut)
        ((37, 53), (111, 17)),       # up in one axis, down in the other
        ((20, 30), (20, 30)),        # same size
    ],
)
def test_resize_uint8_linear_equals_cv2(src, dst):
    img = np.random.RandomState(sum(src)).randint(0, 256, (*src, 3)).astype(np.uint8)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_uint8_linear(torch.from_numpy(img), dst)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_k1_log_sum_exp():
    """The plain K1's log-sum-exp against ``torch.logsumexp`` of the scores
    built here in float64 (q·k·scale + the table bias), 1e-5 absolute."""
    rng = np.random.RandomState(5)
    BG, H, W, Ns, g, h_g, th = 4, 6, 7, 9, 2, 2, 13
    q, k, v = (torch.tensor(rng.randn(*s) * 0.5, dtype=torch.float32)
               for s in ((BG, H, W, 64), (BG, Ns, 64), (BG, Ns, 64)))
    pos = torch.tensor(rng.uniform(-1.2, 1.2, (BG, Ns, 2)), dtype=torch.float32)
    table = torch.tensor(rng.randn(g, h_g, th, th) * 0.1, dtype=torch.float32)
    kw = dict(n_groups=g, scale=32 ** -0.5)
    out, lse = da.deform_attn_reference(q, k, v, pos, table, return_lse=True, **kw)
    assert torch.equal(out, da.deform_attn_reference(q, k, v, pos, table, **kw))
    scores = torch.einsum("bmhc,bnhc->bhmn", q.double().reshape(BG, H * W, h_g, 32),
                          k.double().reshape(BG, Ns, h_g, 32)) * kw["scale"]
    scores = scores + da.rpe_bias(pos.double(), table.double(), H, W)
    assert lse.shape == (BG, h_g, H * W)
    torch.testing.assert_close(lse.double(), torch.logsumexp(scores, -1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [16, 136, 299])
def test_query_coords_divide_exactly(n):
    want = np.arange(n, dtype=np.float32) / np.float32(n - 1) * np.float32(2) - np.float32(1)
    np.testing.assert_array_equal(da.query_coords(n, n).numpy(), want)
