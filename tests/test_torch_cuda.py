"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; skips elsewhere. This file
imports neither JAX nor the JAX package, so it also runs on a machine
without them, with the JAX-pinning conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

``test_two_gloo_ranks_on_the_card_equal_one_process`` runs the scale-out's
step over two processes on the card (``tests/torch_parallel_worker.py``).
The last three tests run the eval slice on the card's machine: its JPEG
decoder against the fixture's stored cv2 decodes, ``evaluate_dataset``
card against CPU, and a reference ``.pth`` loaded on the card;
``test_exported_small_model_on_the_card`` the serving export (an artifact
exported and served on the card against the live model, with K1's and
K3's launches); ``test_an_artifact_serves_where_nvcc_is_not`` the
artifact's own kernel library, served by a process that cannot compile;
``test_small_mixed_mode_model_matches_cpu`` a model whose position-bias
modes send two 'D' blocks to K1 and two to the composite. The last tests
hold ``SegInferencer``'s CUDA graphs: a replay equals the eager forward
bit for bit (every position-bias mode, the UperNet, plain and exact),
returns a fresh tensor, counts its kernels on the card's track and its
counters as the eager forward, and shows its kernels under the profiler.

Tolerances, as in chip_smoke.py: float32 1e-4 (the kernel sums in another
order and uses the fast exp), bf16 1e-2 (outputs rounded to bf16, and the
plain version rounds P to bf16 before P·V); the small model's logits 1e-4
in float32 with TF32 off (cuDNN against the CPU, and the kernel). K2, K3
and the train step: see the constants below.
"""

import copy
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dat_segmentation_tpu_torch import (
    SegInferencer, build_model, create_train_state, get_config, make_train_step)
from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
from dat_segmentation_tpu_torch.data.image_io import imread_gray, imread_rgb
from dat_segmentation_tpu_torch.eval.evaluate import evaluate_dataset
from dat_segmentation_tpu_torch.tools.reference_schema import save_reference
from dat_segmentation_tpu_torch.train.checkpoint import load_pretrained, merge_pretrained
from dat_segmentation_tpu_torch.ops import deform_attn as da
from dat_segmentation_tpu_torch.ops import x_block as xb
from dat_segmentation_tpu_torch.ops.deform_attn import (
    deform_attn,
    deform_attn_bwd,
    deform_attn_bwd_reference,
    deform_attn_reference,
)
from torch_port_helpers import small_classifier, small_fpn, small_upernet, with_modes

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# K2, relative to the largest |gradient| of each of the five: the kernel
# sums dk, dv, dpos and dtable with float32 atomics in an order that
# changes from run to run; in bf16 dq, dk and dv are rounded to bf16 and
# the plain version rounds P to bf16 before P·V.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GRADS = ("dq", "dk", "dv", "dpos", "dtable")
# K3, max |error| over max |value| of the plain version's output: float32,
# the kernel sums the products and convs in another order; bf16, both round
# at the composite's points, but cuDNN and cuBLAS sum the plain version's
# convs and products in float32 and round once where the kernel also does,
# and one bf16 ulp is 2^-8 relative.
XB_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, B=2, g=2, h_g=2, H=16, W=24, Ns=49, th=27, pos_range=1.2, seed=0):
    rng = np.random.RandomState(seed)
    Cg = h_g * 32
    arrs = [rng.randn(B * g, H, W, Cg) * 0.5, rng.randn(B * g, Ns, Cg) * 0.5,
            rng.randn(B * g, Ns, Cg) * 0.5, rng.uniform(-pos_range, pos_range, (B * g, Ns, 2)),
            rng.randn(g, h_g, th, th) * 0.1]
    t = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrs]
    return t[0].to(dtype), t[1].to(dtype), t[2].to(dtype), t[3], t[4].to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape",
    [
        dict(),  # rectangular, Ns 49 (not a multiple of 32), pos outside [-1, 1]
        dict(g=1, H=128, W=128, Ns=256, th=111, pos_range=1.0),  # T++ stage 0
        dict(g=2, h_g=3, H=64, W=64, Ns=256, th=55, pos_range=1.0),  # S++ stage 1
        dict(B=1, g=1, H=3, W=5, Ns=4, th=13),  # fewer queries than a warp step
        # Ns 1064 (stage 0 of a 896 x 1195 image): K and V of a head do not
        # fit in shared memory beside the 111 x 111 table, so K1 takes the
        # samples in chunks
        dict(B=1, g=1, H=30, W=37, Ns=1064, th=111, pos_range=1.0),
        dict(g=2, H=32, W=32, Ns=256, th=27, pos_range=3.0),  # taps wholly outside the table
        dict(g=1, H=136, W=136, Ns=289, th=111, pos_range=1.0),  # stage 0 of a 544² crop
        # T++ stage 3: 16 x 16 queries, so a block's 128-query tile spans 8
        # image rows
        dict(g=8, H=16, W=16, Ns=256, th=13, pos_range=1.0),
        # the classifier at 224²: Ns 49, less than one 64-sample chunk; stage
        # 3's 49 queries, less than one 128-query tile; stage 2's 14 x 14
        dict(g=8, H=7, W=7, Ns=49, th=13, pos_range=1.0),
        dict(g=4, H=14, W=14, Ns=49, th=27, pos_range=1.0),
    ],
)
def test_kernel_matches_plain(cuda, dtype, shape):
    q, k, v, pos, table = _inputs(cuda, dtype, **shape)
    kw = dict(n_groups=table.shape[0], scale=32 ** -0.5)
    with torch.inference_mode():
        got = deform_attn(q, k, v, pos, table, **kw)
        ref = deform_attn_reference(q, k, v, pos, table, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_padded_queries(cuda):
    """hn/wn set the coordinates; rows past them are computed and discarded."""
    q, k, v, pos, table = _inputs(cuda, torch.float32, H=32, W=32)
    kw = dict(n_groups=2, scale=32 ** -0.5, hn=28, wn=28)
    with torch.inference_mode():
        got = deform_attn(q, k, v, pos, table, **kw)
        ref = deform_attn_reference(q, k, v, pos, table, **kw)
        unpadded = deform_attn_reference(
            q[:, :28, :28].contiguous(), k, v, pos, table, n_groups=2, scale=32 ** -0.5
        )
    assert (got - ref).abs().max().item() <= TOL[torch.float32]
    assert (got[:, :28, :28] - unpadded).abs().max().item() <= TOL[torch.float32]


@pytest.mark.cuda
def test_kernel_padded_queries_bf16(cuda):
    """As above, in bf16 (the tensor-core instance)."""
    q, k, v, pos, table = _inputs(cuda, torch.bfloat16, H=32, W=32)
    kw = dict(n_groups=2, scale=32 ** -0.5, hn=28, wn=28)
    with torch.inference_mode():
        got = deform_attn(q, k, v, pos, table, **kw)
        ref = deform_attn_reference(q, k, v, pos, table, **kw)
        unpadded = deform_attn_reference(
            q[:, :28, :28].contiguous(), k, v, pos, table, n_groups=2, scale=32 ** -0.5
        )
    assert (got.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]
    assert (got[:, :28, :28].float() - unpadded.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_launches_are_counted(cuda):
    q, k, v, pos, table = _inputs(cuda, torch.bfloat16)
    before = deform_attn.launches
    with torch.inference_mode():
        deform_attn(q, k, v, pos, table, n_groups=2, scale=0.2)
        deform_attn(q, k, v, pos, table, n_groups=2, scale=0.2)
    assert deform_attn.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize(
    "spoil,error",
    [
        (lambda t: (t[0].float(),) + t[1:], TypeError),  # q f32, k v table bf16
        (lambda t: t[:3] + (t[3].to(torch.bfloat16), t[4]), TypeError),  # pos not f32
        (lambda t: (t[0].transpose(1, 2),) + t[1:], ValueError),  # not contiguous
        (lambda t: (t[0][..., :48].contiguous(),) + t[1:], ValueError),  # head width 24
        (lambda t: t[:4] + (t[4][:1].contiguous(),), ValueError),  # 1 table, 2 groups
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, spoil, error):
    args = spoil(_inputs(cuda, torch.bfloat16))
    with torch.inference_mode(), pytest.raises(error):
        deform_attn(*args, n_groups=2, scale=0.2)


def _rel_errs(got, ref):
    return {name: ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-12)).item()
            for name, a, b in zip(GRADS, got, ref)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape",
    [
        dict(),  # rectangular, Ns 49, pos outside [-1, 1]
        dict(g=1, H=128, W=128, Ns=256, th=111, pos_range=1.0),  # T++ stage 0
        dict(g=8, H=16, W=16, Ns=256, th=13, pos_range=1.0),  # T++ stage 3
        dict(g=2, h_g=3, H=64, W=64, Ns=256, th=55, pos_range=1.0),  # S++ stage 1
        dict(B=1, g=1, H=3, W=5, Ns=4, th=13),  # fewer queries than a block step
        dict(g=1, H=136, W=136, Ns=289, th=111, pos_range=1.0),  # stage 0 of a 544² crop
        dict(B=1, g=1, H=224, W=299, Ns=1064, th=111, pos_range=1.0),  # 896x1195, Ns 1064
        # the classifier at 224² (Ns 49, less than one 128-sample chunk):
        # stage 3 at batch 16 (BG 128 batch-groups summed into dtable), stage 2
        dict(B=16, g=8, H=7, W=7, Ns=49, th=13, pos_range=1.0),
        dict(g=4, H=14, W=14, Ns=49, th=27, pos_range=1.0),
    ],
)
def test_bwd_kernel_matches_plain(cuda, dtype, shape):
    q, k, v, pos, table = _inputs(cuda, dtype, **shape)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(1),
                       device=cuda).to(dtype)
    kw = dict(n_groups=table.shape[0], scale=32 ** -0.5)
    got = deform_attn_bwd(q, k, v, pos, table, dout, **kw)
    ref = deform_attn_bwd_reference(q, k, v, pos, table, dout, **kw)
    torch.cuda.synchronize()
    assert [t.shape for t in got] == [t.shape for t in ref]
    errs = _rel_errs(got, ref)
    assert max(errs.values()) <= BWD_TOL[dtype], errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape",
    [
        dict(g=1, H=128, W=128, Ns=256, th=111, pos_range=1.0),  # T++ stage 0
        dict(g=1, H=30, W=37, Ns=49, th=27),  # ragged: Ns and H*W not multiples of a tile
    ],
    ids=["stage0", "ragged"],
)
def test_k1_log_sum_exp_leaves_the_output_alone(cuda, dtype, shape):
    """With a gradient wanted K1 also writes each query's log-sum-exp (to
    1e-4 of the plain version's); its output is bit for bit the serving
    launch's, which writes none."""
    q, k, v, pos, table = _inputs(cuda, dtype, **shape)
    kw = dict(n_groups=1, scale=32 ** -0.5)
    with torch.inference_mode():
        serve = deform_attn(q, k, v, pos, table, **kw)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, pos, table)]
    train = deform_attn(*leaves, **kw)
    out, lse = da._fwd_kernel(q, k, v, pos, table, 1, kw["scale"], 0, 0, with_lse=True)
    _, ref_lse = deform_attn_reference(q, k, v, pos, table, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(train.detach(), serve) and torch.equal(out, serve)
    assert (lse - ref_lse.float()).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_bwd_kernel_padded_queries(cuda):
    q, k, v, pos, table = _inputs(cuda, torch.float32, H=32, W=32)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    kw = dict(n_groups=2, scale=32 ** -0.5, hn=28, wn=28)
    errs = _rel_errs(deform_attn_bwd(q, k, v, pos, table, dout, **kw),
                     deform_attn_bwd_reference(q, k, v, pos, table, dout, **kw))
    assert max(errs.values()) <= BWD_TOL[torch.float32], errs


@pytest.mark.cuda
def test_autograd_runs_k1_then_k2(cuda):
    """Under autograd the wrapper launches K1 forward and K2 backward, and
    a float32 master table gets its gradient in float32."""
    q, k, v, pos, table = _inputs(cuda, torch.bfloat16)
    table = table.float()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, pos, table)]
    fwd0, bwd0 = deform_attn.launches, deform_attn_bwd.launches
    out = deform_attn(*leaves, n_groups=2, scale=32 ** -0.5)
    out.float().square().sum().backward()
    assert (deform_attn.launches, deform_attn_bwd.launches) == (fwd0 + 1, bwd0 + 1)
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16] * 3 + [torch.float32] * 2
    ref = deform_attn_bwd_reference(q, k, v, pos, table.to(torch.bfloat16),
                                    2 * out.detach(), n_groups=2, scale=32 ** -0.5)
    errs = _rel_errs([t.grad for t in leaves], ref)
    assert max(errs.values()) <= BWD_TOL[torch.bfloat16], errs


@pytest.mark.cuda
def test_small_model_kernel_path_matches_plain_path(cuda):
    """The small SemanticFPN (head width 32) on the card against the same
    model on the CPU, where every kernel is its plain version."""
    torch.manual_seed(0)
    model = build_model(small_fpn(get_config, head_width=32), device=cuda)
    x = torch.tensor(np.random.RandomState(1).randn(2, 64, 96, 3), dtype=torch.float32)
    before = deform_attn.launches
    with torch.inference_mode():
        got = model(x.to(cuda)).cpu()
        ref = copy.deepcopy(model).cpu()(x)
    assert deform_attn.launches == before + 4  # one per 'D' block
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_small_model_exact_padded_forward_on_the_card(cuda):
    """Exact padded inference on the card: the small SemanticFPN (head width
    32) on a 64x96 bucket holding a 52x76 and a 61x64 image, against each
    image's true-shape forward on the card (K1) and the padded batch on the
    CPU; the exact forward launches no K1 (the JAX gate), the true-shape
    ones one a 'D' block."""
    from dat_segmentation_tpu_torch.ops.valid_extent import stride4_extent

    torch.manual_seed(0)
    model = build_model(small_fpn(get_config, head_width=32), device=cuda).eval()
    rng = np.random.RandomState(2)
    shapes = ((52, 76), (61, 64))
    imgs = [torch.tensor(rng.randn(h, w, 3), dtype=torch.float32) for h, w in shapes]
    x = torch.zeros(2, 64, 96, 3)
    for i, im in enumerate(imgs):
        x[i, :im.shape[0], :im.shape[1]] = im
    valid = torch.tensor(shapes, dtype=torch.int32)
    before = deform_attn.launches
    with torch.inference_mode():
        got = model(x.to(cuda), upsample=False, valid_hw=valid.to(cuda)).cpu()
        assert deform_attn.launches == before
        ref = copy.deepcopy(model).cpu()(x, upsample=False, valid_hw=valid)
        for i, im in enumerate(imgs):
            eh, ew = (int(v) for v in stride4_extent(im.shape[:2], True))
            true = model(im[None].to(cuda), upsample=False).cpu()[0]
            assert true.shape[:2] == (eh, ew)
            assert (got[i, :eh, :ew] - true).abs().max().item() <= 1e-4
    assert deform_attn.launches == before + 2 * 4  # one per 'D' block, true shapes only
    assert (got - ref).abs().max().item() <= 1e-4


def _small_upernet_step_card_vs_cpu(cuda, use_checkpoint, modes=("continuous",) * 4):
    """One float32 train step of the small UperNet (head width 32, its 'D'
    blocks in ``modes``) on the card and on the CPU; returns the card's
    (K1, K2) launches."""
    torch.manual_seed(0)
    cfg = get_config("upn_tiny_160k_dp03_lr6")
    model_cfg = with_modes(small_upernet(get_config, head_width=32), modes)
    model_cfg = dataclasses.replace(model_cfg, backbone=dataclasses.replace(
        model_cfg.backbone, use_checkpoint=use_checkpoint))
    cfg = dataclasses.replace(cfg, model=model_cfg,
                              schedule=dataclasses.replace(cfg.schedule, warmup_iters=0))
    gpu = build_model(model_cfg, device=cuda)
    cpu = copy.deepcopy(gpu).cpu()
    rng = np.random.RandomState(3)
    label = rng.randint(0, 8, (2, 64, 96))
    label[:, :5] = 255
    batch = {"image": rng.randn(2, 64, 96, 3).astype(np.float32), "label": label}
    out = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        state = create_train_state(m, cfg)
        fwd0, bwd0 = deform_attn.launches, deform_attn_bwd.launches
        _, metrics = make_train_step(m, num_classes=8, compute_dtype=torch.float32)(state, batch)
        out[name] = (metrics, deform_attn.launches - fwd0, deform_attn_bwd.launches - bwd0)
    (gm, gf, gb), (cm, _, _) = out["gpu"], out["cpu"]
    assert abs(gm["loss"].item() - cm["loss"].item()) <= 1e-5 * abs(cm["loss"].item())
    dsq = sum((pg.grad.cpu() - pc.grad).square().sum() for pg, pc in zip(gpu.parameters(), cpu.parameters()))
    gsq = sum(pc.grad.square().sum() for pc in cpu.parameters())
    assert (dsq / gsq).sqrt().item() <= 1e-4
    for (n, bg), (_, bc) in zip(gpu.named_buffers(), cpu.named_buffers()):
        if n.endswith(("running_mean", "running_var")):
            assert (bg.cpu() - bc).abs().max().item() <= 1e-5, n
    return gf, gb


@pytest.mark.cuda
def test_small_upernet_train_step_matches_cpu(cuda):
    """One float32 train step of the small UperNet (head width 32) on the
    card, through K1 and K2, against the same step on the CPU: loss to
    1e-5 relative, all gradients to 1e-4 (||g_card - g_cpu|| / ||g_cpu||),
    BN running statistics to 1e-5; one K1 and one K2 launch per 'D'
    block."""
    assert _small_upernet_step_card_vs_cpu(cuda, use_checkpoint=False) == (4, 4)


MIXED_MODES = ("dwc_pe", "continuous", "log_cpb", "continuous")


@pytest.mark.cuda
def test_small_mixed_mode_model_matches_cpu(cuda):
    """The small UperNet (head width 32) with dwc_pe, the continuous bias,
    log_cpb and the continuous bias on its four stages: K1 runs on the two
    continuous 'D' blocks only (the JAX gate), the composite on the other
    two. The eval forward's logits card vs CPU to 1e-4 (2 K1 launches),
    then one float32 train step under the gates above (2 K1 and 2 K2)."""
    torch.manual_seed(0)
    model = build_model(with_modes(small_upernet(get_config, head_width=32), MIXED_MODES),
                        device=cuda)
    x = torch.tensor(np.random.RandomState(1).randn(2, 64, 96, 3), dtype=torch.float32)
    before = deform_attn.launches
    with torch.inference_mode():
        got = model(x.to(cuda)).cpu()
        launches = deform_attn.launches - before
        ref = copy.deepcopy(model).cpu()(x)
    assert launches == 2
    assert (got - ref).abs().max().item() <= 1e-4
    assert _small_upernet_step_card_vs_cpu(cuda, False, MIXED_MODES) == (2, 2)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_equal_one_process(cuda, tmp_path):
    """The small UperNet (head width 32, drop path and dropout 0.1), one
    float32 step over two gloo ranks on the card (NCCL refuses two ranks on
    one GPU) against the one-process card step on the concatenated batch
    (rank 1's labels 90% ignored): loss to 1e-5 relative, all gradients to
    1e-4 (K2's float32 atomics and the all-reduces sum in other orders),
    the two replicas bit for bit equal, 4 K1 and 4 K2 launches a rank."""
    import torch_parallel_worker as W

    model_cfg = small_upernet(get_config, head_width=32, drop=0.1)
    torch.manual_seed(0)
    weights = tmp_path / "w.pt"
    torch.save(build_model(model_cfg, device="cpu").state_dict(), weights)
    kw = dict(weights=weights, batches=W.seg_batches(steps=1), model_cfg=model_cfg,
              device="cuda")
    ctx = W.spawn(tmp_path / "ranks", [("seg", "seg_steps", kw)], device="cuda")
    try:
        (one,) = W.seg_steps(0, 1, **kw)["steps"]
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    (r0,), (r1,) = (r["seg"]["steps"] for r in W.collect(ctx, tmp_path / "ranks"))
    want = one["metrics"]["loss"]
    for got in (r0, r1):
        assert abs(got["metrics"]["loss"] - want) <= 1e-5 * abs(want)
        dsq = sum(float(np.square(got["grads"][n] - g).sum()) for n, g in one["grads"].items())
        gsq = sum(float(np.square(g).sum()) for g in one["grads"].values())
        assert (dsq / gsq) ** 0.5 <= 1e-4
        assert got["launches"] == (4, 4)
    for name in r0["state"]:
        np.testing.assert_array_equal(r0["state"][name], r1["state"][name], err_msg=name)


@pytest.mark.cuda
def test_model_axis_on_the_card_equals_one_process(cuda, tmp_path):
    """fsdp='model' on {data: 1, model: 2}: the small UperNet (offset groups
    1, 1, 2, 2: stages 2 and 3 split by group) over two gloo ranks on the
    card, one float32 step against the one-process card step on the same
    batch: loss to 1e-5 relative, all gradients (gathered whole) to 1e-4,
    the ranks' gathered states bit for bit equal, 4 K1 and 4 K2 launches a
    rank, the split stages' on half their groups."""
    import torch_parallel_worker as W

    model_cfg = small_upernet(get_config, head_width=32, drop=0.1)
    torch.manual_seed(0)
    weights = tmp_path / "w.pt"
    torch.save(build_model(model_cfg, device="cpu").state_dict(), weights)
    kw = dict(weights=weights, batches=W.seg_batches(steps=1), model_cfg=model_cfg,
              device="cuda")
    ctx = W.spawn(tmp_path / "ranks", [("tp", "seg_steps", dict(
        kw, mesh_shape={"data": 1, "model": 2}, fsdp="model", groups=True))], device="cuda")
    try:
        one = W.seg_steps(0, 1, groups=True, **kw)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    ranks = [r["tp"] for r in W.collect(ctx, tmp_path / "ranks")]
    (want,) = one["steps"]
    for rank in ranks:
        (got,) = rank["steps"]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= 1e-5 * abs(
            want["metrics"]["loss"])
        dsq = sum(float(np.square(got["grads"][n] - g).sum()) for n, g in want["grads"].items())
        gsq = sum(float(np.square(g).sum()) for g in want["grads"].values())
        assert (dsq / gsq) ** 0.5 <= 1e-4
        assert got["launches"] == (4, 4)
        # (B·g, H) of each K1 launch: the split stages' (4² and 2² at 64²) halved
        assert rank["groups"] == [(b // 2 if h <= 4 else b, h) for b, h in one["groups"]]
        for name in want["state"]:
            np.testing.assert_array_equal(got["state"][name], ranks[0]["steps"][0]["state"][name],
                                          err_msg=name)


@pytest.mark.cuda
def test_spatial_axis_on_the_card_equals_one_process(cuda, tmp_path):
    """{data: 1, spatial: 2}: the small UperNet (drop path and dropout 0.1)
    over two gloo ranks on the card, each image's rows split over them, one
    float32 step with 'auto' and one with 'pallas' (K3 on halo slabs)
    against the one-process card step on the same batch: loss to 1e-5
    relative, all gradients to 1e-4, 4 K1 and 4 K2 launches a rank (and
    with 'pallas' the one-process step's K3 launches), each K1 call on one
    whole-map batch row of the two, and the ranks' states bit for bit
    equal."""
    import torch_parallel_worker as W

    model_cfg = small_upernet(get_config, head_width=32, drop=0.1)
    torch.manual_seed(0)
    weights = tmp_path / "w.pt"
    torch.save(build_model(model_cfg, device="cpu").state_dict(), weights)
    kw = dict(weights=weights, batches=W.seg_batches(steps=1), model_cfg=model_cfg,
              device="cuda", groups=True)
    impls = ("auto", "pallas")
    ctx = W.spawn(tmp_path / "ranks", [(impl, "seg_steps", dict(
        kw, kernel_impl=impl, mesh_shape={"data": 1, "spatial": 2})) for impl in impls],
        device="cuda")
    try:
        one = {impl: W.seg_steps(0, 1, kernel_impl=impl, **kw) for impl in impls}
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    ranks = W.collect(ctx, tmp_path / "ranks")
    for impl in impls:
        (want,) = one[impl]["steps"]
        assert want["k3_launches"] == (3 if impl == "pallas" else 0)
        for rank in ranks:
            (got,) = rank[impl]["steps"]
            assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= 1e-5 * abs(
                want["metrics"]["loss"])
            dsq = sum(float(np.square(got["grads"][n] - g).sum())
                      for n, g in want["grads"].items())
            gsq = sum(float(np.square(g).sum()) for g in want["grads"].values())
            assert (dsq / gsq) ** 0.5 <= 1e-4, impl
            assert got["launches"] == (4, 4) and got["k3_launches"] == want["k3_launches"]
            # (B·g, H) of each K1 launch: one of the two batch rows, whole maps
            assert rank[impl]["groups"] == [(b // 2, h) for b, h in one[impl]["groups"]]
            for name in want["state"]:
                np.testing.assert_array_equal(got["state"][name],
                                              ranks[0][impl]["steps"][0]["state"][name],
                                              err_msg=name)


@pytest.mark.cuda
def test_small_upernet_checkpointed_train_step_matches_cpu(cuda):
    """The same with ``use_checkpoint=True``: the same gates, and each 'D'
    block's K1 twice (the stages run again in the backward)."""
    assert _small_upernet_step_card_vs_cpu(cuda, use_checkpoint=True) == (8, 4)


def _xb_inputs(device, dtype, B=2, H=16, W=24, C=64, k=7, mode="lpu", seed=0):
    """x and the port's parameter tensors of one fused X block (mode 'lpu',
    'x' without the LPU, or 'mlp'), weights at 1/sqrt(fan-in)."""
    rng = np.random.RandomState(seed)
    E = 4 * C

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.randn(*shape) * scale + shift, dtype=torch.float32,
                            device=device).to(dtype)

    p = dict(w3=None, b3=None, w7=None, b7=None)
    if mode == "lpu":
        p.update(w3=t(C, 1, 3, 3, scale=1 / 3), b3=t(C, scale=0.1))
    if mode != "mlp":
        p.update(w7=t(C, 1, k, k, scale=1 / k), b7=t(C, scale=0.1))
    p.update(g=t(C, scale=0.1, shift=1.0), be=t(C, scale=0.1), wf1=t(E, C, scale=C ** -0.5),
             bf1=t(E, scale=0.1), wd=t(E, 1, 3, 3, scale=1 / 3), bd=t(E, scale=0.1),
             wf2=t(C, E, scale=E ** -0.5), bf2=t(C, scale=0.1))
    return t(B, H, W, C), p


def _xb_rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape",
    [
        dict(),  # X block with the LPU, 16 x 24
        dict(B=1, H=128, W=128, C=64),  # T++ stage 0
        dict(B=1, H=32, W=32, C=256, mode="mlp"),  # T++ stage 2, MLP-only
        dict(B=1, H=48, W=80, C=96),  # rectangular, the S++ stage-0 width
        dict(B=1, H=16, W=16, C=768, mode="mlp"),  # S++ stage 3
        dict(B=1, H=20, W=36, C=128, mode="x"),  # no LPU; sides not multiples of the tile
        dict(H=8, W=8, C=64, k=3),
        dict(H=8, W=16, C=32, k=5),
        dict(H=12, W=16, C=64, k=9),
        dict(B=1, H=20, W=36, C=64),  # sides not multiples of the 16 x 8 tile
        dict(B=1, H=20, W=36, C=64, mode="mlp"),
        # the DAT-B++ widths in both modes (C = 1024: the widest weight stream)
        dict(B=1, H=16, W=24, C=128),
        dict(B=1, H=16, W=24, C=128, mode="mlp"),
        dict(B=1, H=16, W=16, C=256),
        dict(B=1, H=16, W=16, C=256, mode="mlp"),
        dict(B=1, H=8, W=16, C=512),
        dict(B=1, H=8, W=16, C=512, mode="mlp"),
        dict(B=1, H=6, W=12, C=1024),
        dict(B=1, H=8, W=8, C=1024, mode="mlp"),
    ],
)
def test_x_block_kernel_matches_plain(cuda, dtype, shape):
    x, p = _xb_inputs(cuda, dtype, **shape)
    lpu = shape.get("mode", "lpu") == "lpu"
    names = ("w3", "b3", "w7", "b7", "g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")
    with torch.inference_mode():
        before = xb.x_block_fwd.launches
        got = xb.x_block_fwd(x, *(p[n] for n in names), with_lpu=lpu)
        ref = xb.x_block_reference(x, *(p[n] for n in names), with_lpu=lpu)
    torch.cuda.synchronize()
    assert xb.x_block_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _xb_rel(got, ref) <= XB_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["lpu", "mlp"])
def test_x_block_two_launches_agree_bit_for_bit(cuda, dtype, mode):
    """K3 has no atomics and no order that changes between runs."""
    x, p = _xb_inputs(cuda, dtype, B=1, H=20, W=36, C=96, mode=mode)
    names = ("w3", "b3", "w7", "b7", "g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")
    with torch.inference_mode():
        a = xb.x_block_fwd(x, *(p[n] for n in names), with_lpu=mode == "lpu")
        b = xb.x_block_fwd(x, *(p[n] for n in names), with_lpu=mode == "lpu")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("preset", ["upn_tiny_160k_dp03_lr6", "upn_small_160k", "upn_base_160k"])
def test_x_block_tile_fits_every_preset_width(cuda, dtype, preset):
    """A tile that fits the card's shared memory at each width of the T++,
    S++ and B++ presets, in both modes (the window the presets use)."""
    bb = get_config(preset).model.backbone
    for C, k in zip(bb.dims, bb.window_sizes):
        for mode, kk in ((xb.MODE_X_LPU, k), (xb.MODE_X, k), (xb.MODE_MLP, 1)):
            assert xb.tile_rows(dtype, C, mode, kk) > 0, (C, mode)
            assert xb.resident_warps(dtype, C, mode, kk)[0] > 0, (C, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lpu", "mlp"])
def test_x_block_function_grads_on_the_card(cuda, mode):
    """XBlockFunction: K3 forward (one launch), backward by autograd of the
    plain version, equal to autograd of the plain version itself; the
    absent parameters get None."""
    x, p = _xb_inputs(cuda, torch.float32, mode=mode)
    names = ("w3", "b3", "w7", "b7", "g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")
    leaves = {n: (None if v is None else v.requires_grad_(True)) for n, v in p.items()}
    xg = x.clone().requires_grad_(True)
    cot = torch.randn(x.shape, generator=torch.Generator(cuda).manual_seed(3), device=cuda)
    before = xb.x_block_fwd.launches
    if mode == "mlp":
        out = xb.fused_conv_mlp(xg, *(leaves[n] for n in names[4:]))
    else:
        out = xb.fused_x_block(xg, *(leaves[n] for n in names), 7, True)
    assert xb.x_block_fwd.launches == before + 1
    (out * cot).sum().backward()
    present = [n for n in names if leaves[n] is not None]
    xr = x.clone().requires_grad_(True)
    pr = {n: leaves[n].detach().clone().requires_grad_(True) for n in present}
    ref = xb.x_block_reference(xr, *(pr.get(n) for n in names), with_lpu=mode == "lpu")
    (ref * cot).sum().backward()
    assert _xb_rel(out.detach(), ref.detach()) <= XB_TOL[torch.float32]
    assert (xg.grad - xr.grad).abs().max().item() <= 1e-5 * xr.grad.abs().max().item()
    for n in present:
        assert (leaves[n].grad - pr[n].grad).abs().max().item() <= 1e-5 * pr[n].grad.abs().max().item(), n
    assert all(leaves[n] is None for n in names if n not in present)


@pytest.mark.cuda
def test_small_model_pallas_path_matches_cpu(cuda):
    """The small SemanticFPN (head width 32) with kernel_impl='pallas' on
    the card at 64x64 (K3 at stages 0 and 1: the 'D' block of stage 0 and
    the 'X' and 'D' blocks of stage 1) against the same model on the CPU."""
    torch.manual_seed(0)
    cfg = small_fpn(get_config, head_width=32)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, kernel_impl="pallas"))
    model = build_model(cfg, device=cuda)
    x = torch.tensor(np.random.RandomState(1).randn(2, 64, 64, 3), dtype=torch.float32)
    before = xb.x_block_fwd.launches
    with torch.inference_mode():
        got = model(x.to(cuda)).cpu()
        ref = copy.deepcopy(model).cpu()(x)
    assert xb.x_block_fwd.launches == before + 3
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_small_upernet_pallas_train_step_matches_cpu(cuda):
    """One float32 train step of the small UperNet with kernel_impl='pallas'
    (K3 forward, autograd of its plain version backward) on the card
    against the CPU: the tolerances of the unfused step above."""
    torch.manual_seed(0)
    cfg = get_config("upn_tiny_160k_dp03_lr6")
    model_cfg = small_upernet(get_config, head_width=32)
    model_cfg = dataclasses.replace(
        model_cfg, backbone=dataclasses.replace(model_cfg.backbone, kernel_impl="pallas"))
    cfg = dataclasses.replace(cfg, model=model_cfg,
                              schedule=dataclasses.replace(cfg.schedule, warmup_iters=0))
    gpu = build_model(model_cfg, device=cuda)
    cpu = copy.deepcopy(gpu).cpu()
    rng = np.random.RandomState(3)
    label = rng.randint(0, 8, (2, 64, 64))
    label[:, :5] = 255
    batch = {"image": rng.randn(2, 64, 64, 3).astype(np.float32), "label": label}
    out = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        state = create_train_state(m, cfg)
        before = xb.x_block_fwd.launches
        _, metrics = make_train_step(m, num_classes=8, compute_dtype=torch.float32)(state, batch)
        out[name] = (metrics, xb.x_block_fwd.launches - before)
    (gm, gl), (cm, cl) = out["gpu"], out["cpu"]
    assert (gl, cl) == (3, 0)
    assert abs(gm["loss"].item() - cm["loss"].item()) <= 1e-5 * abs(cm["loss"].item())
    dsq = sum((pg.grad.cpu() - pc.grad).square().sum() for pg, pc in zip(gpu.parameters(), cpu.parameters()))
    gsq = sum(pc.grad.square().sum() for pc in cpu.parameters())
    assert (dsq / gsq).sqrt().item() <= 1e-4


# -- the ADE20K val path on the card's machine ----------------------------------

ADE_TINY = Path(__file__).resolve().parent / "data" / "ade20k_tiny"
# The JPEG decoder against cv2's stored decodes, as chip_smoke.py gates it:
# both run libjpeg-turbo's defaults; builds may round a chroma-upsampled
# pixel one grey level apart.
DECODE_MAX_DIFF, DECODE_MAX_SHARE = 1, 0.01


@pytest.mark.cuda
def test_image_reads_against_cv2_decodes(cuda):
    """The machine's JPEG decoder (Pillow) against the fixture's stored cv2
    decodes within the gate, and the PNG reader's masks bit for bit."""
    digests = json.loads((ADE_TINY / "cv2_digests.json").read_text())
    for name, d in digests["masks"].items():
        mask = imread_gray(ADE_TINY / "annotations" / "validation" / name)
        assert hashlib.sha256(mask.tobytes()).hexdigest() == d["sha256"], name
    for path in sorted((ADE_TINY / "decode").glob("*.jpg")):
        got = imread_rgb(path).astype(np.int16)
        ref = np.load(path.with_suffix(".npz"))["rgb"].astype(np.int16)
        assert got.shape == ref.shape
        diff = np.abs(got - ref)
        assert diff.max() <= DECODE_MAX_DIFF and (diff > 0).mean() <= DECODE_MAX_SHARE, path.name


@pytest.mark.cuda
def test_small_evaluate_card_vs_cpu(cuda):
    """evaluate_dataset of the small SemanticFPN (head width 32, 150
    classes) on the fixture at img_scale (128, 64), float32, card against
    CPU: a pixel may differ only where the CPU's top two logits are within
    2e-4 (the logits agree within 1e-4), and such pixels stay under 1e-3."""
    torch.manual_seed(0)
    model = build_model(small_fpn(get_config, head_width=32, num_classes=150), device="cpu")
    ds = ADE20KDataset(ADE_TINY, "val")
    preds, infs = {}, {}
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        infs[name] = SegInferencer(model, num_classes=150, compute_dtype=torch.float32, device=dev)
        preds[name] = {}
        before = deform_attn.launches
        res = evaluate_dataset(infs[name], ds, img_scale=(128, 64), verbose=False,
                               on_pred=lambda i, p, n=name: preds[n].__setitem__(i, p))
        assert res["num_images"] == 6
        assert (deform_attn.launches - before > 0) == (name == "card")
    flipped = total = 0
    for i, pred in preds["card"].items():
        differ = pred != preds["cpu"][i]
        if differ.any():
            raw, gt = ds.load_raw(i)
            (inp, _), = infs["cpu"].tta_inputs(raw, img_scale=(128, 64))
            lg = torch.nn.functional.interpolate(
                torch.from_numpy(infs["cpu"].logits(inp))[None].permute(0, 3, 1, 2),
                size=gt.shape, mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
            top2 = lg.topk(2, dim=-1).values
            assert ((top2[..., 0] - top2[..., 1]).numpy()[differ] <= 2e-4).all()
        flipped, total = flipped + int(differ.sum()), total + pred.size
    assert flipped <= 1e-3 * total


@pytest.mark.cuda
def test_load_pretrained_on_the_card(cuda, tmp_path):
    """A mmseg-schema .pth of the small UperNet loads into a model on the
    card with an empty report and equal tensors."""
    cfg = small_upernet(get_config, head_width=32)
    torch.manual_seed(0)
    src = build_model(cfg, device=cuda)
    path = save_reference(src, cfg, tmp_path / "upn_mmseg.pth")
    torch.manual_seed(1)
    dst = build_model(cfg, device=cuda)
    _, report = merge_pretrained(dst, load_pretrained(str(path), cfg), verbose=False,
                                 return_report=True)
    assert report == {"missing": [], "unexpected": [], "mismatched": []}
    want = src.state_dict()
    for k, v in dst.state_dict().items():
        assert v.device.type == "cuda" and torch.equal(v, want[k]), k


# -- the seg trainer on the card ------------------------------------------------


@pytest.mark.cuda
def test_device_prefetch_on_the_card(cuda):
    """Each batch is copied on a side stream; the consumer's stream waits for
    it. Read back after a long product queued on the default stream (a read
    that did not wait would race the copy), every batch equals its host
    batch, in order; a producer's exception reaches the consumer."""
    from dat_segmentation_tpu_torch.data.loader import device_prefetch

    rng = np.random.RandomState(0)
    host = [{"image": rng.randn(4, 256, 256, 3).astype(np.float32),
             "label": rng.randint(0, 150, (4, 256, 256)).astype(np.int32), "path": [str(i)]}
            for i in range(6)]
    default = torch.cuda.current_stream(cuda)
    x = torch.randn(2048, 2048, device=cuda)
    got = []
    for i, b in enumerate(device_prefetch(iter(host), cuda)):
        assert b["path"] == [str(i)] and b["image"].device.type == "cuda"
        assert torch.cuda.current_stream(cuda) == default
        for _ in range(4):
            x = x @ x / 2048
        got.append(((b["image"] + 0).cpu().numpy(), b["label"].cpu().numpy()))
    assert len(got) == len(host)
    for (img, lab), h in zip(got, host):
        np.testing.assert_array_equal(img, h["image"])
        np.testing.assert_array_equal(lab, h["label"])

    def failing():
        yield host[0]
        raise KeyError("decode failed")

    gen = device_prefetch(failing(), cuda)
    next(gen)
    with pytest.raises(KeyError, match="decode failed"):
        next(gen)


def _train_layout(root):
    for split in ("training", "validation"):
        for kind, suffix in (("images", ".jpg"), ("annotations", ".png")):
            (root / kind / split).mkdir(parents=True)
            for p in sorted((ADE_TINY / kind / "validation").glob(f"*{suffix}")):
                (root / kind / split / p.name).symlink_to(p)
    return root


@pytest.mark.cuda
def test_small_train_segmentation_on_the_card(cuda, tmp_path):
    """Two bf16 steps of the small UperNet (head width 32) through
    ``train_segmentation`` on the card: finite losses, K1 and K2 launched,
    ``ckpt_2`` restored bit for bit (model, AdamW, step and the CUDA
    generator's state, through ``torch.save`` and ``map_location``), then a
    resume to step 3."""
    from dat_segmentation_tpu_torch.configs.schema import replace
    from dat_segmentation_tpu_torch.train.checkpoint import CheckpointManager
    from dat_segmentation_tpu_torch.train.trainer_seg import train_segmentation

    cfg = get_config("upn_tiny_160k_dp03_lr6")
    cfg = replace(dataclasses.replace(cfg, model=small_upernet(get_config, head_width=32,
                                                               num_classes=150)), **{
        "data.data_root": str(_train_layout(tmp_path / "data")), "data.batch_size": 2,
        "data.crop_size": (64, 64), "data.num_workers": 2, "schedule.warmup_iters": 0,
        "log_interval": 1, "checkpoint_interval": 2, "eval_interval": 2,
        "work_dir": str(tmp_path / "work"), "name": "small"})
    da.deform_attn.launches = da.deform_attn_bwd.launches = 0
    state, hist = train_segmentation(cfg, max_iters=2, eval_max_images=1)
    assert state.step == 2 and len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert 0.0 <= hist["val_miou"][0] <= 1.0
    assert state.generator.device.type == "cuda"
    assert da.deform_attn.launches > 0 and da.deform_attn_bwd.launches > 0
    saved = CheckpointManager(tmp_path / "work" / "small").restore(2, map_location="cpu")
    assert saved["step"] == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v.cpu()), k
    opt = state.optimizer.state_dict()
    for i, st in opt["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(saved["optimizer"]["state"][i][k]).cpu(),
                               torch.as_tensor(v).cpu()), (i, k)
    assert torch.equal(saved["generator"], state.generator.get_state())
    state, hist = train_segmentation(cfg, resume=True, max_iters=3, eval_max_images=1)
    assert state.step == 3 and len(hist["loss"]) == 1
    log = (tmp_path / "work" / "small" / "train.log").read_text()
    assert "resumed from iter 2" in log


@pytest.mark.cuda
def test_small_classifier_forward_and_cls_step_match_cpu(cuda):
    """The small DatClassifier (head width 32) at 64² (stage sides 16/8/4/2,
    Ns 4) on the
    card against the same model on the CPU, float32: the logits to 1e-4;
    one cls train step with mixup from fixed CutMix draws: loss to 1e-5
    relative, all gradients to 1e-4, acc1 equal; one K1 and one K2 launch
    a 'D' block."""
    from dat_segmentation_tpu_torch.data.mixup import MixupDraws

    class Fixed:
        def draw(self, h, w):
            return MixupDraws(use_cutmix=True, lam_mix=0.3, lam_cut=0.55, cy=20, cx=40)

    torch.manual_seed(0)
    model_cfg = small_classifier(get_config, head_width=32)
    cfg = dataclasses.replace(get_config("cls_tiny_imagenet"), model=model_cfg)
    cfg = dataclasses.replace(cfg, schedule=dataclasses.replace(cfg.schedule, warmup_iters=0))
    gpu = build_model(model_cfg, device=cuda)
    cpu = copy.deepcopy(gpu).cpu()
    rng = np.random.RandomState(4)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    with torch.inference_mode():
        got = gpu(torch.from_numpy(x).to(cuda)).cpu()
        ref = cpu(torch.from_numpy(x))
    assert got.shape == (4, 10) and (got - ref).abs().max().item() <= 1e-4
    batch = {"image": x, "label": rng.randint(0, 10, 4)}
    out = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        state = create_train_state(m, cfg)
        state.mixup = Fixed()
        fwd0, bwd0 = deform_attn.launches, deform_attn_bwd.launches
        step = make_train_step(m, task="cls", num_classes=10, compute_dtype=torch.float32,
                               mixup=True)
        _, metrics = step(state, batch)
        out[name] = (metrics, deform_attn.launches - fwd0, deform_attn_bwd.launches - bwd0)
    (gm, gf, gb), (cm, _, _) = out["gpu"], out["cpu"]
    assert (gf, gb) == (4, 4)
    assert abs(gm["loss"].item() - cm["loss"].item()) <= 1e-5 * abs(cm["loss"].item())
    assert gm["acc1"].item() == cm["acc1"].item()
    # out_norm_0-2 feed nothing the classifier reads: no gradient on either side
    pairs = [(pg.grad, pc.grad) for pg, pc in zip(gpu.parameters(), cpu.parameters())]
    assert [g is None for g, _ in pairs] == [c is None for _, c in pairs]
    dsq = sum((g.cpu() - c).square().sum() for g, c in pairs if c is not None)
    gsq = sum(c.square().sum() for _, c in pairs if c is not None)
    assert (dsq / gsq).sqrt().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kind,launches", [("fpn", (4, 0)), ("fpn_pallas", (4, 3)),
                                           ("classifier", (4, 0))])
def test_exported_small_model_on_the_card(cuda, tmp_path, kind, launches):
    """The small SemanticFPN (portable, and with ``kernel_impl='pallas'``
    and ``portable=False``) and the small DatClassifier (head width 32),
    exported on the card in float32 (TF32 off) at 64x64 and served by
    ``ServingModel``, against the live model on the card: equal within
    1e-5 relative (the same kernels on the same inputs), and the forward's
    (K1, K3) launches: one K1 a 'D' block, K3 at stages 0 and 1."""
    from dat_segmentation_tpu_torch.serving import (ServingModel, export_classifier,
                                                    export_segmentor, save_artifact)

    torch.manual_seed(0)
    if kind == "classifier":
        cfg = small_classifier(get_config, head_width=32)
    else:
        cfg = small_fpn(get_config, head_width=32)
        if kind == "fpn_pallas":
            cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                        kernel_impl="pallas"))
    model = build_model(cfg, device=cuda)
    export = export_classifier if kind == "classifier" else export_segmentor
    program = export(cfg, model.state_dict(), batch=2, input_size=(64, 64),
                     compute_dtype=torch.float32, device=cuda, portable=kind != "fpn_pallas")
    srv = ServingModel.load(save_artifact(tmp_path, {"e": program}, model_cfg=cfg,
                                          task="classifier" if kind == "classifier" else "segmentor"))
    assert srv.entries["e"]["device"].startswith("cuda")
    x = torch.tensor(np.random.RandomState(1).randn(2, 64, 64, 3), dtype=torch.float32)
    srv("e", x)
    before = (deform_attn.launches, xb.x_block_fwd.launches)
    got = srv("e", x)
    assert (deform_attn.launches - before[0], xb.x_block_fwd.launches - before[1]) == launches
    with torch.inference_mode():
        want = (model(x.to(cuda)) if kind == "classifier" else model(x.to(cuda), upsample=False))
    assert got.device.type == "cuda" and got.shape == want.shape
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.cuda
def test_an_artifact_serves_where_nvcc_is_not(cuda, tmp_path):
    """The small SemanticFPN exported on the card carries K1's library.
    A fresh process whose PATH and CUDA_HOME hide nvcc, importing a copy of
    the package without ``_build/``, serves it: the logits bit for bit the
    in-process ones (the same binary on the same input, TF32 off in both),
    nothing built."""
    import os
    import shutil
    import subprocess
    import sys

    from dat_segmentation_tpu_torch.ops import cuda_build
    from dat_segmentation_tpu_torch.serving import ServingModel, export_segmentor, save_artifact

    torch.manual_seed(0)
    cfg = small_fpn(get_config, head_width=32)
    model = build_model(cfg, device=cuda)
    program = export_segmentor(cfg, model.state_dict(), batch=2, input_size=(64, 64),
                               compute_dtype=torch.float32, device=cuda)
    art = save_artifact(tmp_path / "art", {"e": program}, model_cfg=cfg)
    srv = ServingModel.load(art)
    assert [lib["op"] for lib in srv.meta["kernel_libraries"]] == ["dat::deform_attn_fwd"]
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    want = srv("e", x).cpu().numpy()

    pkg = cuda_build.CSRC.parent
    root = tmp_path / "copy"
    shutil.copytree(pkg, root / pkg.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (tmp_path / "empty").mkdir()
    path = [d for d in os.environ.get("PATH", "").split(":") if d and not (Path(d) / "nvcc").exists()]
    env = dict(os.environ, PYTHONPATH=str(root), CUDA_HOME=str(tmp_path / "empty"),
               PATH=":".join(path))
    code = (
        "import sys, numpy as np, torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False\n"
        "from dat_segmentation_tpu_torch.ops import cuda_build\n"
        "from dat_segmentation_tpu_torch.serving import ServingModel\n"
        "try:\n"
        "    sys.exit(f'nvcc found: {cuda_build.nvcc_path()}')\n"
        "except RuntimeError:\n"
        "    pass\n"
        f"y = ServingModel.load({str(art)!r})('e', np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.cpu().numpy())\n"
        "print(cuda_build.CSRC, cuda_build.BUILD_DIR.exists())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    csrc, built = proc.stdout.split()[-2:]
    assert csrc.startswith(str(root.resolve())) and built == "False"
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


# -- the served forward replayed from a CUDA graph -----------------------------
# A replay launches the kernels that the eager forward launches, on the same
# buffers' contents, with the algorithms the libraries chose for the eager
# call of the same shape: its logits equal the eager forward's bit for bit.


def _graph_server(cuda, dtype=torch.bfloat16):
    """``SegInferencer`` over the small SemanticFPN (head width 32: K1 in
    each of its four 'D' blocks) on the card."""
    torch.manual_seed(0)
    model = build_model(small_fpn(get_config, head_width=32), device=cuda)
    return SegInferencer(model, num_classes=8, compute_dtype=dtype, device=cuda)


def _batches(n, shape=(2, 64, 96, 3), seed=5):
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(*shape), dtype=torch.float32) for _ in range(n)]


def _eager(server, x, valid=None):
    """The served forward run eagerly, outside ``forward_batch``."""
    with torch.inference_mode():
        x = x.to(server.device, server.compute_dtype)
        if valid is None:
            return server.model(x, upsample=False).float()
        valid = torch.as_tensor(valid, dtype=torch.int32, device=server.device)
        return server.model(x, upsample=False, valid_hw=valid).float()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_a_repeated_shape_replays_the_eager_forward(cuda, dtype):
    server = _graph_server(cuda, dtype)
    a, b = _batches(2)
    first = server.forward_batch(a)  # the key's first sighting: eager
    assert not server._graphs.graphs
    again = server.forward_batch(a)  # its second: captured, then replayed
    assert len(server._graphs.graphs) == 1
    other = server.forward_batch(b)  # replayed
    assert again.dtype == torch.float32
    assert torch.equal(again, first)
    assert torch.equal(other, _eager(server, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_each_request_keeps_its_own_output(cuda, dtype):
    """Batches of one shape give their own logits (the static input is
    refreshed), and a returned tensor is left alone by later requests."""
    server = _graph_server(cuda, dtype)
    xs = _batches(4)
    outs = [server.forward_batch(x) for x in xs]  # eager, capture, replay, replay
    kept = [o.clone() for o in outs]
    for x in reversed(xs):
        server.forward_batch(x)
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert not torch.equal(outs[2], outs[3])
    for x, o, k in zip(xs, outs, kept):
        assert torch.equal(o, k)
        assert torch.equal(o, _eager(server, x))


@pytest.mark.cuda
def test_an_exact_key_replays_with_each_requests_valid_hw(cuda):
    """One graph serves every ``valid_hw`` of a padded shape: the masks and
    resize matrices are built from the extents on the card."""
    server = _graph_server(cuda)
    xs = _batches(4)
    valids = [np.array(v, np.int32) for v in ([[52, 76], [61, 64]], [[64, 96], [49, 80]],
                                              [[33, 90], [60, 70]], [[64, 40], [40, 96]])]
    outs = [server.forward_batch(x, valid_hw=v) for x, v in zip(xs, valids)]
    assert len(server._graphs.graphs) == 1
    server.forward_batch(xs[0])  # the plain key of the shape is another
    server.forward_batch(xs[0])
    assert len(server._graphs.graphs) == 2
    outs.append(server.forward_batch(xs[0], valid_hw=valids[2]))
    for x, v, o in zip(xs + [xs[0]], valids + [valids[2]], outs):
        assert torch.equal(o, _eager(server, x, v))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["plain", "valid_hw"])
@pytest.mark.parametrize("model", ["continuous", "dwc_pe", "fixed_pe", "log_cpb", "no_off",
                                   "no_pe", "upernet"])
def test_every_model_replays_its_eager_forward(cuda, model, exact):
    """Each position-bias mode (the small SemanticFPN with it in every
    stage: K1 or the composite) and the small UperNet capture, plain and
    exact, and replay their eager forwards."""
    torch.manual_seed(0)
    cfg = (small_upernet(get_config, head_width=32) if model == "upernet" else
           with_modes(small_fpn(get_config, head_width=32), (model,) * 4))
    server = SegInferencer(build_model(cfg, device=cuda), num_classes=8, device=cuda)
    xs = _batches(3)
    valid = np.array([[52, 76], [61, 64]], np.int32) if exact else None
    outs = [server.forward_batch(x, valid_hw=valid) for x in xs]
    assert len(server._graphs.graphs) == 1
    for x, o in zip(xs, outs):
        assert torch.equal(o, _eager(server, x, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["plain", "valid_hw"])
def test_a_replay_counts_as_the_eager_forward(cuda, exact):
    """A request, eager, captured and replayed: K1's kernels on the card's
    track (4 plain, 0 exact), the composite's calls (0 plain, 4 exact) and
    ``serve.graph`` (the replayed requests); K1's wrapper is called by the
    eager forward and the capture, not by a replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dat_segmentation_tpu_torch.utils import profiling

    server = _graph_server(cuda)
    x = _batches(1)[0]
    valid = np.array([[52, 76], [61, 64]], np.int32) if exact else None
    got, wrapper = [], []
    for _ in range(4):  # eager, capture, replay, replay
        before = deform_attn.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            server.forward_batch(x, valid_hw=valid)
            torch.cuda.synchronize()
        kernels = sum("deform_attn_fwd" in e.name for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False))
        rec = profiling.recorded()  # sessions back to back: this request's root is the last
        root = [s.id for s in rec.spans if s.name == "dat.serve"][-1]
        got.append((kernels, rec.counts.get(("attn.composite", root), 0),
                    rec.counts.get(("serve.graph", root), 0)))
        wrapper.append(deform_attn.launches - before)
    want = (0, 4) if exact else (4, 0)
    assert got == [want + (0,)] + [want + (1,)] * 3
    assert wrapper == [want[0]] * 2 + [0] * 2


@pytest.mark.cuda
def test_a_traced_replay_shows_its_kernels(cuda):
    """Under the profiler a replayed request's kernels are on the device's
    track by name: K1 once a 'D' block."""
    from torch.profiler import ProfilerActivity, profile

    server = _graph_server(cuda)
    x = _batches(1)[0]
    server.forward_batch(x)
    server.forward_batch(x)  # captured outside the session
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.forward_batch(x)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    assert sum("deform_attn_fwd" in n for n in kernels) == 4, kernels
