"""The port's scale-out on the CPU: two gloo processes against one, and
once against the JAX package's two-device step.

One module fixture starts two ranks (``tests/torch_parallel_worker.py``,
no JAX) and, while they run, computes the one-process references in this
process (no process group) and the JAX step on a ``{"data": 2}`` mesh of
the virtual CPU devices. The bar: a step over two processes equals the
port's one-process step on the concatenation of their batches (which
``tests/test_torch_train.py`` holds to the JAX step), with drop path on
(the masks are drawn over the global batch) and one rank's labels 90%
ignored (the losses divide by the global count).

Tolerances, float32 throughout, the two sides summing in other orders
(the IoU counts: ``_assert_counts_close``):
loss rtol 1e-5 and BatchNorm running statistics after a first step rtol
1e-4 / atol 1e-6 (the JAX package's ``test_parallel.py``); gradients of a
first step per leaf ||dg|| <= 1e-4 ||g||
+ 1e-6 ||g_all|| (a leaf whose gradient is 0 in exact arithmetic, such as
``proj_k.bias``, holds float32 noise on both sides); parameters per leaf
||dp|| <= 1e-4 ||p|| + 1e-6 ||p_all|| on every leaf whose gradient is not
such noise (||g_leaf|| > 1e-6 ||g_all||), and the first leaf elementwise
at rtol 1e-4 / atol 1e-6 (the JAX test's check): AdamW's first steps move
an element by about lr * sign(g), so an element whose gradient is at
rounding level (a noise leaf's, or a ``rpe_table`` entry at the edge of
the sampled region) steps either way on the two sides, by up to 2 lr, in
a leaf whose norm may be as small as its few steps (a bias that starts at
0).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as W
from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.configs.schema import OptimizerConfig as JaxOptimizerConfig
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.parallel import TrainState as JaxTrainState
from dat_segmentation_tpu.parallel import make_mesh
from dat_segmentation_tpu.parallel import make_train_step as jax_make_train_step
from dat_segmentation_tpu.parallel.mesh import shard_batch
from dat_segmentation_tpu.train import make_optimizer as jax_make_optimizer
from dat_segmentation_tpu.train import schedules as jsched
from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.data.mixup import MixupDraws
from dat_segmentation_tpu_torch.parallel import local_batch_size, process_shard_info, resolve_mesh
from dat_segmentation_tpu_torch.train import trainer_seg
from dat_segmentation_tpu_torch.train.checkpoint import CheckpointManager
from dat_segmentation_tpu_torch.utils.convert import convert_variables
from torch_port_helpers import random_variables

FIXTURE = Path(__file__).resolve().parent / "data" / "ade20k_tiny"
IMAGENET = Path(__file__).resolve().parent / "data" / "imagenet_tiny"
DRAWS = [MixupDraws(use_cutmix=True, lam_mix=0.5, lam_cut=0.64, cy=20, cx=41),
         MixupDraws(use_cutmix=False, lam_mix=0.3125, lam_cut=0.5, cy=0, cx=0)]
VALID = np.array([True, True, True, False])  # rank 1's last row padded


def _layout(root):
    """The fixture's six images as the train and the val split."""
    for split in ("training", "validation"):
        for kind, suffix in (("images", ".jpg"), ("annotations", ".png")):
            (root / kind / split).mkdir(parents=True)
            for p in sorted((FIXTURE / kind / "validation").glob(f"*{suffix}")):
                (root / kind / split / p.name).symlink_to(p)
    return root


def _jax_two_device_step(variables, batch):
    """The JAX step on {"data": 2} from ``variables``: metrics, final state."""
    jcfg = W.tiny_seg(jax_get_config, drop=0.0)
    jmodel = jax_build_model(jcfg.model)
    sched = jsched.warmup_poly_schedule(W.LR, 20, warmup_iters=0, warmup_ratio=1e-6, power=1.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(sched, params, weight_decay=0.01,
                            no_decay_keys=JaxOptimizerConfig().no_decay_keys)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                          tx=tx)
    mesh = make_mesh({"data": 2}, devices=jax.devices("cpu")[:2])
    step = jax_make_train_step(jmodel, mesh, aux_weight=0.4, num_classes=W.NUM_CLASSES,
                               compute_dtype=jnp.float32)
    state, m = step(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
                    jax.random.PRNGKey(0))
    final = {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}
    return {k: np.asarray(v) for k, v in m.items()}, convert_variables(final)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    data = _layout(tmp / "data")
    torch.manual_seed(0)
    seg_w, cls_w, jax_w = tmp / "seg.pt", tmp / "cls.pt", tmp / "jax_seg.pt"
    torch.save(build_model(W.tiny_seg(get_config).model, device="cpu").state_dict(), seg_w)
    torch.save(build_model(W.tiny_cls(get_config).model, device="cpu").state_dict(), cls_w)
    jcfg = W.tiny_seg(jax_get_config, drop=0.0)
    variables = random_variables(jax_build_model(jcfg.model), np.zeros((1, 64, 64, 3), np.float32),
                                 seed=3, train=False)
    torch.save(convert_variables(variables), jax_w)
    batches = W.seg_batches()
    rng = np.random.RandomState(5)
    cls_batch = {"image": rng.randn(4, 64, 64, 3).astype(np.float32),
                 "label": rng.randint(0, 10, 4).astype(np.int64)}
    one_proc_done = tmp / "w0.done"
    seg = dict(weights=seg_w, batches=batches)
    tasks = [
        ("seg", "seg_steps", seg),
        ("seg_pallas", "seg_steps", dict(seg, kernel_impl="pallas")),
        ("fsdp_pallas", "seg_steps", dict(seg, kernel_impl="pallas", fsdp=True)),
        ("ckpt", "seg_steps", dict(seg, use_checkpoint=True)),
        ("fsdp_ckpt", "seg_steps", dict(seg, use_checkpoint=True, fsdp=True)),
        ("seg_jax", "seg_steps", dict(weights=jax_w, batches=batches[:1], drop=0.0)),
        ("cls", "cls_steps", dict(weights=cls_w, batch=cls_batch, draws=DRAWS, valid=VALID)),
        ("eval", "evaluate", dict(weights=seg_w, root=data, max_images=4)),
        ("cls_val", "cls_val", dict(weights=cls_w, root=IMAGENET)),
        ("cls_train", "cls_train", dict(root=IMAGENET, work=tmp / "w3")),
        ("train", "train", dict(root=data, work=tmp / "w1", max_iters=2, fsdp=True)),
        ("sigterm", "train", dict(root=data, work=tmp / "w2", max_iters=4, sigterm_after=1)),
        ("resume", "train", dict(root=data, work=tmp / "w0", max_iters=3, resume=True,
                                 fsdp=True, wait_for=one_proc_done)),
    ]
    ctx = W.spawn(tmp / "ranks", tasks)
    try:
        # the one-process references on the whole batches, meanwhile
        out = {"one": {
            "seg": W.seg_steps(0, 1, **seg),
            "seg_jax": W.seg_steps(0, 1, weights=jax_w, batches=batches[:1], drop=0.0),
            "cls": W.cls_steps(0, 1, weights=cls_w, batch=cls_batch, draws=list(DRAWS),
                               valid=VALID),
            "eval": W.evaluate(0, 1, weights=seg_w, root=data, max_images=4),
            "cls_val": W.cls_val(0, 1, weights=cls_w, root=IMAGENET, batch_size=4),
            "train": W.train(0, 1, root=data, work=tmp / "w0", max_iters=2),
        }}
        one_proc_done.touch()  # the ranks resume from its ckpt_2
        out["jax"] = _jax_two_device_step(variables, batches[0])
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    out["ranks"] = W.collect(ctx, tmp / "ranks")
    out.update(tmp=tmp, data=data)
    return out


def _grad_scale(grads):
    return float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))


def _noise(grads):
    """The leaves whose gradient is float32 noise (||g_leaf|| <= 1e-6 ||g||)."""
    total = _grad_scale(grads)
    return {n for n, g in grads.items() if np.linalg.norm(g) <= 1e-6 * total}


def _assert_step_equal(got, want, what, grads=None, first_step=True):
    """``got`` (a rank's step record) against ``want`` under the module's
    tolerances; the leaves whose gradient is noise in ``grads`` (default
    ``want``'s) are left out of the parameters' check. Gradients, and the
    BN statistics elementwise, only at a first step: after it the noise
    elements have stepped apart, and what they move differs more (later
    BN statistics are held by the parameters' norm rule). Returns the noise
    leaves."""
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5,
                               err_msg=what)
    if want["grads"] and first_step:
        total = _grad_scale(want["grads"])
        for name, g in want["grads"].items():
            assert (np.linalg.norm(got["grads"][name] - g)
                    <= 1e-4 * np.linalg.norm(g) + 1e-6 * total), (what, name)
    noise = _noise(grads or want["grads"])
    p_all = _grad_scale({n: w for n, w in want["state"].items() if n in (grads or want["grads"])})
    first = next(iter(want["state"]))
    np.testing.assert_allclose(got["state"][first], want["state"][first], rtol=1e-4, atol=1e-6,
                               err_msg=f"{what}: {first}")
    for name, w in want["state"].items():
        if name in noise or name.endswith("num_batches_tracked"):
            continue
        if first_step and name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][name], w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{what}: {name}")
        else:
            dp = np.linalg.norm(got["state"][name] - w)
            assert dp <= 1e-4 * np.linalg.norm(w) + 1e-6 * p_all, (what, name, dp)
    return noise


def _assert_counts_close(got, want, pixels=4 * 64 * 64):
    """The step's global IoU counts: a pixel whose top two logits are
    within float32 rounding may flip its argmax between the two sides (one
    count in inter, two in union), at most 1e-3 of the global batch's
    pixels; counts of one rank's batch alone would be thousands off."""
    d = sum(np.abs(np.asarray(got[k], np.int64) - np.asarray(want[k], np.int64)).sum()
            for k in ("inter", "union"))
    assert d <= 3 * 1e-3 * pixels, d


def test_resolve_mesh_refuses_what_is_not_ported():
    """The data, model and spatial axes are ported: without a group the
    data axis is 1, a spatial axis above 1 is a mesh larger than the group
    (``ValueError`` naming the group's size), as is any mesh larger than the
    group, and fsdp over a missing axis raises ``ValueError``
    (``tests/test_torch_model_axis.py`` and
    ``tests/test_torch_spatial_axis.py`` hold the two other axes)."""
    assert resolve_mesh({"data": -1}).data == 1 and resolve_mesh({"data": 1, "spatial": 1}).data == 1
    for shape, fsdp in (({"data": -1, "spatial": 2}, False),
                        ({"data": 1, "model": 1, "spatial": 2}, False)):
        with pytest.raises(ValueError, match="group of 1 processes"):
            resolve_mesh(shape, fsdp)
    for shape, fsdp in (({"data": 2}, False), ({"data": 1, "model": 2}, False),
                        ({"data": -1}, "model")):
        with pytest.raises(ValueError):
            resolve_mesh(shape, fsdp)
    assert process_shard_info() == (0, 1) and local_batch_size(16) == 16


def test_seg_step_two_ranks_equal_one(runs):
    """Two steps of the tiny UperNet (drop path 0.1, BN in the heads, rank
    1's labels 90% ignored) over two ranks equal the one-process steps on
    the concatenated batches: loss, gradients, parameters, BN statistics,
    the global metrics; the two replicas are equal bit for bit."""
    one = runs["one"]["seg"]["steps"]
    r0, r1 = (r["seg"]["steps"] for r in runs["ranks"])
    for i, (a, b, want) in enumerate(zip(r0, r1, one)):
        noise = _assert_step_equal(a, want, f"step {i}", first_step=i == 0)
        assert noise <= {n for n in want["grads"] if "proj_k.bias" in n or "out_norm" in n}
        _assert_counts_close(a["metrics"], want["metrics"])
        np.testing.assert_allclose(a["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                                   rtol=1e-4)
        for name in a["state"]:
            np.testing.assert_array_equal(a["state"][name], b["state"][name], err_msg=name)
        for key in a["metrics"]:
            np.testing.assert_array_equal(a["metrics"][key], b["metrics"][key], err_msg=key)
    assert one[1]["metrics"]["loss"] != one[0]["metrics"]["loss"]


def test_cls_step_with_mixup_two_ranks_equal_one(runs):
    """The tiny classifier (drop path 0.1, clip 5.0) takes a CutMix and a
    Mixup step: each rank's images pair with the global batch's mirrors (on
    the other rank), the soft-target CE is over the global batch; and the
    metric step's counts with a padded row are the global counts."""
    one = runs["one"]["cls"]
    for rank in runs["ranks"]:
        got = rank["cls"]
        for i, (a, want) in enumerate(zip(got["steps"], one["steps"])):
            _assert_step_equal(a, want, f"step {i}", first_step=i == 0)
            np.testing.assert_allclose(a["metrics"]["acc1"], want["metrics"]["acc1"], rtol=1e-6)
            np.testing.assert_allclose(a["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                                       rtol=1e-4)
        np.testing.assert_array_equal(got["hits"], one["hits"])
    assert int(one["hits"][2]) == 3


def test_fsdp_equals_replicated_and_shards(runs):
    """Two steps with fsdp=True over two ranks equal the replicated steps
    (with ``kernel_impl='pallas'``: K3's plain version got whole,
    contiguous weights, never a shard), and the largest parameter and its
    AdamW moment really are sharded in halves."""
    for rank in runs["ranks"]:
        rep, fsdp = rank["seg_pallas"], rank["fsdp_pallas"]
        for i, (a, want) in enumerate(zip(fsdp["steps"], rep["steps"])):
            _assert_step_equal(a, dict(want, grads={}), f"step {i}", grads=rep["steps"][0]["grads"])
        assert fsdp["k3_whole_contiguous"] and all(fsdp["k3_whole_contiguous"])
        sh = fsdp["sharded"]
        assert sh["local"][0] * 2 == sh["shape"][0] and sh["local"][1:] == sh["shape"][1:], sh
        assert sh["moment_local"] == sh["local"], sh


def test_fsdp_with_use_checkpoint_equals_replicated_and_one_process(runs):
    """Two steps with ``use_checkpoint`` (each stage recomputed in the
    backward, drop path on) over two ranks, replicated and with fsdp=True
    (the recompute on the parameters FSDP2 gathers again): the replicated
    steps equal the one-process steps without it, and the fsdp steps the
    replicated ones, under the module's tolerances."""
    one = runs["one"]["seg"]["steps"]
    for rank in runs["ranks"]:
        rep, fsdp = rank["ckpt"]["steps"], rank["fsdp_ckpt"]["steps"]
        for i, (a, b, want) in enumerate(zip(rep, fsdp, one)):
            _assert_step_equal(a, want, f"replicated step {i}", first_step=i == 0)
            _assert_step_equal(b, dict(a, grads={}), f"fsdp step {i}", grads=rep[0]["grads"])
            assert a["launches"] == b["launches"] == (0, 0)  # the CPU: plain versions


def test_evaluate_distributed_equals_one_process(runs):
    """``evaluate_dataset(distributed=True)`` over two ranks (two of the
    fixture's first four images each) returns the one-process counts on
    both."""
    want = runs["one"]["eval"]
    assert want["num_images"] == 4
    for rank in runs["ranks"]:
        got = rank["eval"]
        assert got["num_images"] == 4
        assert got["inter"] == want["inter"] and got["union"] == want["union"]
        assert got["mIoU"] == want["mIoU"] and got["aAcc"] == want["aAcc"]


def test_classifier_val_counts_each_item_once(runs):
    """The classifier trainer's val over two ranks (five images: the loader
    pads rank 1's shard with an item of rank 0's, which is masked out)
    gives the one-process counts, five images in all."""
    want = runs["one"]["cls_val"]
    assert want[2] == 5
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank["cls_val"], want)


def test_classifier_trainer_over_two_ranks(runs):
    """``train_classifier`` over two ranks: 12 train images at a global
    batch of 4 are 3 steps an epoch (each rank loads 6); both ranks log
    the same loss and val top-1/5 (counts summed), and rank 0 writes the
    checkpoints."""
    r0, r1 = (r["cls_train"] for r in runs["ranks"])
    assert r0["step"] == r1["step"] == 3
    assert r0["history"] == r1["history"] and np.isfinite(r0["history"]["train_loss"]).all()
    assert r0["ckpts"] == ["backbone_best", "ckpt_1", "ckpt_1.meta.json", "ckpt_best",
                           "ckpt_best.meta.json"]


def test_two_rank_fsdp_checkpoint_resumes_in_one_process(runs):
    """A 2-rank fsdp ``train_segmentation`` (2 iterations, a checkpoint at 2)
    writes the one-process format (the sharded state gathered): the
    checkpoint's model is the ranks' final model, its AdamW moments whole,
    and one process resumes from it."""
    rank0 = runs["ranks"][0]["train"]
    assert rank0["step"] == 2 and "ckpt_2" in rank0["ckpts"] and "ckpt_best" in rank0["ckpts"]
    assert all(np.isfinite(rank0["history"]["loss"])) and len(rank0["history"]["val_miou"]) == 1
    work = runs["tmp"] / "w1"
    saved = CheckpointManager(work / "dp").restore(2, map_location="cpu")
    for name, v in rank0["state"].items():
        np.testing.assert_array_equal(saved["model"][name].numpy(), v, err_msg=name)
    shapes = {tuple(s["exp_avg"].shape) for s in saved["optimizer"]["state"].values()}
    assert shapes == {tuple(v.shape) for k, v in saved["model"].items()
                      if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    cfg = W.trainer_cfg(get_config, runs["data"], work)
    state, hist = trainer_seg.train_segmentation(cfg, device="cpu", max_iters=3, resume=True,
                                                 eval_max_images=1)
    assert state.step == 3 and len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])


def test_one_process_checkpoint_resumes_in_two_ranks(runs):
    """The reverse: one process's ``ckpt_2`` resumed by two fsdp ranks: right
    after the restore each rank's (gathered) model is the one process's
    final model, and the step from it leaves the ranks equal."""
    one = runs["one"]["train"]
    r0, r1 = (r["resume"] for r in runs["ranks"])
    assert one["step"] == 2 and r0["step"] == r1["step"] == 3
    assert len(r0["history"]["loss"]) == 1 and np.isfinite(r0["history"]["loss"][0])
    for name, v in one["state"].items():
        np.testing.assert_array_equal(r0["restored"][name], v, err_msg=name)
        np.testing.assert_array_equal(r1["restored"][name], v, err_msg=name)
    for name in r0["state"]:
        np.testing.assert_array_equal(r0["state"][name], r1["state"][name], err_msg=name)


def test_sigterm_to_one_rank_checkpoints_both_at_one_step(runs):
    """SIGTERM to rank 1 after its first step: both ranks see it at the
    same poll, stop at step 1 and rank 0 writes one preempted checkpoint."""
    r0, r1 = (r["sigterm"] for r in runs["ranks"])
    assert r0["step"] == r1["step"] == 1
    assert r0["ckpts"] == ["ckpt_1", "ckpt_1.meta.json"]
    meta = (runs["tmp"] / "w2" / "dp" / "ckpt_1.meta.json").read_text()
    assert '"preempted": true' in meta


def test_two_rank_step_equals_jax_two_device_step(runs):
    """The 2-rank seg step (drop path 0: the RNGs differ) against the JAX
    ``make_train_step`` on a {"data": 2} mesh, from the same variables on
    the same global batch: loss, grad norm, IoU counts, BN statistics and
    every parameter whose gradient is not noise."""
    metrics, want = runs["jax"]
    for rank in runs["ranks"]:
        (got,) = rank["seg_jax"]["steps"]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], metrics["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["update_ratio"], metrics["update_ratio"],
                                   rtol=1e-3)
        _assert_counts_close(got["metrics"], metrics)
        total = _grad_scale(got["grads"])
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            g = got["state"][name]
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
            elif np.linalg.norm(got["grads"][name]) > 1e-6 * total:
                rel = np.linalg.norm(g - w.numpy()) / np.linalg.norm(w.numpy())
                assert rel <= 1e-4, (name, rel)
