"""The whole mesh on the CPU: the model and spatial axes together, and fsdp
over 'spatial', against one process and against the JAX package's step and
eval step on the same meshes.

Two runs of ranks (``tests/torch_parallel_worker.py``, no JAX): four gloo
ranks on ``{"data": 1, "model": 2, "spatial": 2}`` (rank m·2 + s) and
``{"data": 2, "spatial": 2}``, then eight on ``{"data": 2, "model": 2,
"spatial": 2}`` (rank (d·2 + m)·2 + s), so that every group (data, model,
spatial, and the data × spatial rows group of a model coordinate) carries
something. Meanwhile this process computes the one-process references (no
process group) and the JAX steps on the same meshes of the virtual CPU
devices. The tiny UperNet's offset groups are (1, 2, 2, 4), so stages 1
and 3 split by group under the model axis while each spatial peer holds
half of every image's rows; its 64² images have 16, 8, 4 and 2 rows at the
four stages, and at 32² stage 3's single row leaves spatial peer 1 none
while its model peers split the MLP on it. Drop path, the heads' dropout
and the backbone's dropout (on the MLPs' split hidden units of row shards)
are on, and the global batch's last two rows are 90% ignored. Tolerances:
``tests/test_torch_parallel.py``'s docstring.

The JAX step's ``grad_norm`` on a mesh with both a model and a spatial
axis above 1 is not a reference: XLA's CPU partitioner gives it 4.15-4.50
where the one-device program gives 3.283, whatever fsdp is (ROADMAP.md,
Queue 3, "Noted, in the reference"); AdamW's first step divides by each
leaf's own scale, so the parameters still agree. There the port's norm and
gradients are held to its one-process step, and only the loss, the
parameters and the counts to the JAX step; on ``{"data": 2, "spatial":
2}`` with fsdp='spatial' the JAX norm is sound and held too.
"""

import dataclasses

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
from dat_segmentation_tpu.parallel import make_eval_step as jax_make_eval_step
from dat_segmentation_tpu.parallel import make_mesh
from dat_segmentation_tpu.parallel import make_train_step as jax_make_train_step
from dat_segmentation_tpu.parallel.mesh import shard_batch, shard_state
from dat_segmentation_tpu.train import make_optimizer as jax_make_optimizer
from dat_segmentation_tpu.train import schedules as jsched
from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.parallel import resolve_mesh
from dat_segmentation_tpu_torch.parallel.mesh import mesh_sizes, rank_grid
from dat_segmentation_tpu_torch.train import trainer_seg
from dat_segmentation_tpu_torch.train.checkpoint import CheckpointManager
from dat_segmentation_tpu_torch.utils.convert import convert_variables
from test_torch_parallel import (DRAWS, _assert_counts_close, _assert_step_equal, _grad_scale,
                                 _layout)
from torch_port_helpers import random_variables, with_modes

FULL = {"data": 1, "model": 2, "spatial": 2}
FULL_SM = {"data": 1, "spatial": 2, "model": 2}  # the same axes, spatial before model
DP_SP = {"data": 2, "spatial": 2}
FULL8 = {"data": 2, "model": 2, "spatial": 2}
FULL8_SM = {"data": 2, "spatial": 2, "model": 2}
DROP_RATE = 0.1  # the backbone's dropout: masks on split hidden units of row shards
CLS_SIZE = 96  # stage 3: 3 rows over two spatial peers (2 and 1)
CLS_VALID = np.array([True, True, True, False])
NOISE = ("proj_k.bias", "out_norm")  # leaves whose gradient is 0 in exact arithmetic


def _jax_state(variables):
    jmodel = jax_build_model(W.tiny_seg(jax_get_config, drop=0.0).model)
    sched = jsched.warmup_poly_schedule(W.LR, 20, warmup_iters=0, warmup_ratio=1e-6, power=1.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(sched, params, weight_decay=0.01,
                            no_decay_keys=JaxOptimizerConfig().no_decay_keys)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                          tx=tx)
    return jmodel, state


def _jax_step(variables, batch, shape, fsdp):
    """The JAX step on ``shape`` (images and labels sharded over data and
    spatial) with ``fsdp``, its state placed by ``shard_state`` first:
    metrics and the final state in the port's names."""
    jmodel, state = _jax_state(variables)
    mesh = make_mesh(shape, devices=jax.devices("cpu")[:int(np.prod(list(shape.values())))])
    state = shard_state(mesh, state, fsdp=fsdp)
    step = jax_make_train_step(jmodel, mesh, aux_weight=0.4, num_classes=W.NUM_CLASSES,
                               compute_dtype=jnp.float32, fsdp=fsdp, state=state)
    state, m = step(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
                    jax.random.PRNGKey(0))
    final = {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}
    return {k: np.asarray(v) for k, v in m.items()}, convert_variables(final)


def _jax_eval(variables, image):
    """The JAX ``make_eval_step`` on ``FULL`` (two images, 32 rows a device)."""
    jmodel, state = _jax_state(variables)
    mesh = make_mesh(FULL, devices=jax.devices("cpu")[:4])
    img = shard_batch(mesh, {"image": jnp.asarray(image)})["image"]
    fwd = jax_make_eval_step(jmodel, mesh, compute_dtype=jnp.float32)
    return np.asarray(fwd(state.params, state.batch_stats, img))


def _dwc_model():
    """The tiny UperNet with stage 1's attention in ``dwc_pe`` (a composite
    block, split by offset group under the model axis: its two groups
    divide by 2)."""
    return with_modes(W.tiny_seg(get_config).model, ("continuous", "dwc_pe", "continuous",
                                                     "continuous"))


def _batch(rng, n, size):
    label = rng.randint(0, W.NUM_CLASSES, (n, size, size)).astype(np.int32)
    label[n // 2:][rng.rand(n - n // 2, size, size) < 0.9] = 255
    return {"image": rng.randn(n, size, size, 3).astype(np.float32), "label": label}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("full_mesh")
    data = _layout(tmp / "data")
    torch.manual_seed(0)
    seg_w, cls_w, jax_w, dwc_w = (tmp / f"{n}.pt" for n in ("seg", "cls", "jax", "dwc"))
    torch.save(build_model(W.tiny_seg(get_config).model, device="cpu").state_dict(), seg_w)
    torch.save(build_model(W.tiny_cls(get_config).model, device="cpu").state_dict(), cls_w)
    torch.save(build_model(_dwc_model(), device="cpu").state_dict(), dwc_w)
    variables = random_variables(jax_build_model(W.tiny_seg(jax_get_config, drop=0.0).model),
                                 np.zeros((1, 64, 64, 3), np.float32), seed=3, train=False)
    torch.save(convert_variables(variables), jax_w)
    (batch,) = W.seg_batches(steps=1)
    rng = np.random.RandomState(7)
    small = _batch(rng, 4, 32)  # 32²: stage 3's one row, spatial peer 1 holds none
    cls_batch = {"image": rng.randn(4, CLS_SIZE, CLS_SIZE, 3).astype(np.float32),
                 "label": rng.randint(0, 10, 4).astype(np.int64)}
    image = rng.randn(2, 64, 64, 3).astype(np.float32)
    one_proc_done = tmp / "w0.done"
    seg = dict(weights=seg_w, batches=[batch], drop_rate=DROP_RATE)
    on_jax = dict(weights=jax_w, batches=[batch], drop=0.0)
    tp = dict(mesh_shape=FULL, fsdp="model")
    pallas = dict(seg, drop_rate=0.0, kernel_impl="pallas")  # K3's gate: dropout 0
    # three images a data coordinate, which S = 2 does not divide: every
    # peer gathers the rows for the attention
    dwc = dict(weights=dwc_w, model_cfg=_dwc_model(),
               batches=[{k: v[1:] for k, v in batch.items()}])
    tasks = [
        ("coords", "mesh_coords", dict(shapes=[FULL, FULL_SM, DP_SP])),
        ("tp", "seg_steps", dict(seg, groups=True, **tp)),
        ("rep", "seg_steps", dict(seg, mesh_shape=FULL)),
        ("sp", "seg_steps", dict(seg, mesh_shape=FULL, fsdp="spatial")),
        ("tp_jax", "seg_steps", dict(on_jax, **tp)),
        ("rep_jax", "seg_steps", dict(on_jax, mesh_shape=FULL)),
        ("sp_jax", "seg_steps", dict(on_jax, mesh_shape=FULL, fsdp="spatial")),
        ("dp_sp_jax", "seg_steps", dict(on_jax, mesh_shape=DP_SP, fsdp="spatial")),
        ("small", "seg_steps", dict(weights=seg_w, batches=[small], drop_rate=DROP_RATE, **tp)),
        ("pallas", "seg_steps", dict(pallas, **tp)),
        ("ckpt", "seg_steps", dict(seg, use_checkpoint=True, **tp)),
        ("dwc", "seg_steps", dict(dwc, **tp)),
        ("cls", "cls_steps", dict(weights=cls_w, batch=cls_batch, draws=DRAWS, valid=CLS_VALID,
                                  **tp)),
        ("eval", "eval_logits", dict(weights=jax_w, image=image, **tp)),
        ("train", "train", dict(root=data, work=tmp / "w1", max_iters=2, drop=0.0, **tp)),
        ("resume", "train", dict(root=data, work=tmp / "w0", max_iters=3, resume=True,
                                 wait_for=one_proc_done, drop=0.0, **tp)),
    ]
    # eight ranks: every group of {data: 2, model: 2, spatial: 2}
    tasks8 = [("coords", "mesh_coords", dict(shapes=[FULL8, FULL8_SM])),
              ("tp", "seg_steps", dict(seg, mesh_shape=FULL8, fsdp="model"))]
    ctx = W.spawn(tmp / "ranks", tasks, world=4)
    try:
        # the one-process references on the whole batches, and the JAX steps,
        # meanwhile
        out = {"one": {
            "seg": W.seg_steps(0, 1, groups=True, **seg),
            "seg_jax": W.seg_steps(0, 1, **on_jax),
            "small": W.seg_steps(0, 1, weights=seg_w, batches=[small], drop_rate=DROP_RATE),
            "pallas": W.seg_steps(0, 1, **pallas),
            "dwc": W.seg_steps(0, 1, **dwc),
            "cls": W.cls_steps(0, 1, weights=cls_w, batch=cls_batch, draws=list(DRAWS),
                               valid=CLS_VALID),
            "train": W.train(0, 1, root=data, work=tmp / "w0", max_iters=2, drop=0.0),
        }}
        one_proc_done.touch()  # the ranks resume from its ckpt_2
        out["jax"] = _jax_step(variables, batch, FULL, "model")
        out["ranks"] = W.collect(ctx, tmp / "ranks", world=4)
        ctx = W.spawn(tmp / "ranks8", tasks8, world=8)
        out["jax_dp_sp"] = _jax_step(variables, batch, DP_SP, "spatial")
        out["jax_eval"] = _jax_eval(variables, image)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    out["ranks8"] = W.collect(ctx, tmp / "ranks8", world=8)
    out.update(tmp=tmp, data=data)
    return out


def _assert_ranks_equal(ranks, key):
    """Every rank's gathered state and metrics bit for bit rank 0's."""
    first = ranks[0][key]["steps"]
    for rank in ranks[1:]:
        for a, b in zip(rank[key]["steps"], first):
            for name in b["state"]:
                np.testing.assert_array_equal(a["state"][name], b["state"][name], err_msg=name)
            for m in b["metrics"]:
                np.testing.assert_array_equal(a["metrics"][m], b["metrics"][m], err_msg=m)


def _assert_equals_one(got, want, what, pixels=4 * 64 * 64):
    """A rank's step against the one-process step: loss, every gradient
    (gathered whole; where FSDP2 shards them, the parameters they moved),
    parameters, BN statistics, grad norm and IoU counts. At 64² only the
    leaves whose gradient is 0 in exact arithmetic are noise."""
    sharded = not got["grads"]
    noise = _assert_step_equal(got, dict(want, grads={}) if sharded else want, what,
                               grads=want["grads"])
    if pixels == 4 * 64 * 64:
        assert noise <= {n for n in want["grads"] if any(k in n for k in NOISE)}, (what, noise)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                               rtol=1e-4, err_msg=what)
    _assert_counts_close(got["metrics"], want["metrics"], pixels=pixels)


@pytest.mark.parametrize("shape", [FULL, FULL_SM, FULL8, FULL8_SM])
def test_rank_grid_is_jax_make_mesh(shape):
    """``rank_grid`` puts rank r where JAX's ``make_mesh`` puts device r, in
    the dict's order, whichever of model and spatial comes first; without
    processes it refuses the mesh as larger than the group."""
    n = int(np.prod(list(shape.values())))
    grid = rank_grid(mesh_sizes(shape, n))
    devices = make_mesh(shape, devices=jax.devices("cpu")[:n]).devices
    names = list(shape)
    for r in range(n):
        place = dict(zip(names, (int(i) for i in np.argwhere(
            np.vectorize(lambda dv: dv.id)(devices) == r)[0])))
        assert grid[place["data"], place["model"], place["spatial"]] == r
    with pytest.raises(ValueError, match="group of 1 processes"):
        resolve_mesh(shape)


def test_every_rank_has_its_jax_coordinates(runs):
    """Each of the four and of the eight ranks takes, in the layout
    ``resolve_mesh`` makes, the coordinates its device has in JAX's
    ``make_mesh`` of the same dict, and its data, model, spatial and rows
    groups have the axes' sizes (rows: data × spatial)."""
    for ranks, shapes in ((runs["ranks"], [FULL, FULL_SM, DP_SP]),
                          (runs["ranks8"], [FULL8, FULL8_SM])):
        for i, shape in enumerate(shapes):
            grid = rank_grid(mesh_sizes(shape, len(ranks)))
            sizes = (shape["data"], shape.get("model", 1), shape["spatial"],
                     shape["data"] * shape["spatial"])
            for r, rank in enumerate(ranks):
                got = rank["coords"][i]
                assert grid[got["coords"]] == r, (shape, r, got)
                assert got["group_sizes"] == sizes, (shape, r, got)


def test_seg_step_on_the_full_mesh_equals_one_process(runs):
    """One step on {data: 1, model: 2, spatial: 2} with fsdp='model' (tensor
    parallelism on row shards), False (model peers computing alike) and
    'spatial' (HSDP over the spatial peers), drop path and dropout on
    (the MLPs' masks on split hidden units of row shards): each equals the
    one-process step on the global batch and the four ranks agree bit for
    bit. K1's calls under 'model' hold whole maps of one of the two spatial
    peers' two images and, at stages 1 and 3, half the groups."""
    (want,) = runs["one"]["seg"]["steps"]
    one_groups = runs["one"]["seg"]["groups"]
    split = [(b // 2 // (1 if h == 16 else 2), h) for b, h in one_groups]
    assert [h for _, h in one_groups] == [16, 8, 2]
    for key in ("tp", "rep", "sp"):
        for r, rank in enumerate(runs["ranks"]):
            (got,) = rank[key]["steps"]
            _assert_equals_one(got, want, f"{key} rank {r}")
        _assert_ranks_equal(runs["ranks"], key)
    for rank in runs["ranks"]:
        assert rank["tp"]["groups"] == split


def test_fsdp_over_spatial_holds_half_of_each_leaf(runs):
    """fsdp='spatial': a rank holds 1/S of the largest parameter's rows and
    of its AdamW moment (FSDP2's dim-0 shards over the spatial peers,
    replicated over the data group)."""
    for rank in runs["ranks"]:
        for key in ("sp", "dp_sp_jax"):
            sharded = rank[key]["sharded"]
            want = (-(-sharded["shape"][0] // 2),) + tuple(sharded["shape"][1:])
            assert sharded["local"] == sharded["moment_local"] == want, sharded


def test_full_mesh_steps_equal_jax_step_on_the_same_mesh(runs):
    """The three fsdp legs on {data: 1, model: 2, spatial: 2} from the JAX
    variables (drop 0: the RNGs differ) against the JAX step on the same
    mesh with fsdp='model': loss, update ratio, IoU counts, BN statistics
    and every parameter whose gradient is not noise; the grad norm against
    the port's one-process step (the module docstring says why)."""
    metrics, want = runs["jax"]
    (one,) = runs["one"]["seg_jax"]["steps"]
    assert abs(metrics["grad_norm"] / one["metrics"]["grad_norm"] - 1) > 0.1  # XLA's, not sound
    for key in ("tp_jax", "rep_jax", "sp_jax"):
        for rank in runs["ranks"]:
            (got,) = rank[key]["steps"]
            np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["metrics"]["grad_norm"], one["metrics"]["grad_norm"],
                                       rtol=1e-4)
            np.testing.assert_allclose(got["metrics"]["update_ratio"], metrics["update_ratio"],
                                       rtol=1e-3)
            _assert_counts_close(got["metrics"], metrics)
            _assert_params_close(got["state"], want, one["grads"])


def _assert_params_close(state, want, grads):
    total = _grad_scale(grads)
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        g = state[name]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
        elif np.linalg.norm(grads[name]) > 1e-6 * total:
            rel = np.linalg.norm(g - w.numpy()) / np.linalg.norm(w.numpy())
            assert rel <= 1e-4, (name, rel)


def test_fsdp_over_spatial_equals_jax_and_one_process(runs):
    """fsdp='spatial' on {data: 2, spatial: 2} (no model axis): equal to the
    JAX step on the same mesh with fsdp='spatial', grad norm included (3.283
    on both: sound there), and to the one-process step."""
    metrics, want = runs["jax_dp_sp"]
    (one,) = runs["one"]["seg_jax"]["steps"]
    np.testing.assert_allclose(metrics["grad_norm"], one["metrics"]["grad_norm"], rtol=1e-4)
    for rank in runs["ranks"]:
        (got,) = rank["dp_sp_jax"]["steps"]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], metrics["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["update_ratio"], metrics["update_ratio"],
                                   rtol=1e-3)
        _assert_counts_close(got["metrics"], metrics)
        _assert_params_close(got["state"], want, one["grads"])
        _assert_equals_one(got, one, "dp x sp fsdp='spatial'")
    _assert_ranks_equal(runs["ranks"], "dp_sp_jax")


def test_eight_ranks_on_every_group_equal_one_process(runs):
    """{data: 2, model: 2, spatial: 2} with fsdp='model': the data group
    sums two data coordinates' rows, the rows group four row shards, the
    model group the split products; the step equals one process's and the
    eight ranks agree bit for bit."""
    (want,) = runs["one"]["seg"]["steps"]
    for r, rank in enumerate(runs["ranks8"]):
        (got,) = rank["tp"]["steps"]
        _assert_equals_one(got, want, f"8 ranks, rank {r}")
    _assert_ranks_equal(runs["ranks8"], "tp")


def test_a_peer_without_rows_still_joins_its_model_group(runs):
    """At 32² stage 3 has one row: spatial peer 1 holds none, yet its split
    MLP (an all-reduce of empty partial sums) and the split attention's
    gathers run with its model peer's; the step equals one process's."""
    (want,) = runs["one"]["small"]["steps"]
    for r, rank in enumerate(runs["ranks"]):
        (got,) = rank["small"]["steps"]
        _assert_equals_one(got, want, f"32² rank {r}", pixels=4 * 32 * 32)
    _assert_ranks_equal(runs["ranks"], "small")


def test_k3_and_use_checkpoint_on_the_full_mesh(runs):
    """``kernel_impl='pallas'``: K3's plain version on each rank's halo slab
    with the MLP weights gathered whole and contiguous over the model group,
    as many times as in one process; ``use_checkpoint``: each stage again in
    the backward with both axes' collectives in the forward's order, the
    dropout masks replayed. Both equal their one-process steps."""
    one = runs["one"]["pallas"]
    for r, rank in enumerate(runs["ranks"]):
        got = rank["pallas"]
        assert got["k3_whole_contiguous"] and all(got["k3_whole_contiguous"])
        assert len(got["k3_whole_contiguous"]) == len(one["k3_whole_contiguous"])
        _assert_equals_one(got["steps"][0], one["steps"][0], f"pallas rank {r}")
        _assert_equals_one(rank["ckpt"]["steps"][0], runs["one"]["seg"]["steps"][0],
                           f"checkpointed rank {r}")
    _assert_ranks_equal(runs["ranks"], "pallas")
    _assert_ranks_equal(runs["ranks"], "ckpt")


def test_composite_block_whole_on_gathered_rows(runs):
    """Stage 1 in ``dwc_pe`` (a composite block, no K1: split by offset
    group under the model axis, ``rpe_dwc`` by channel) with three images a
    data coordinate, which S = 2 does not divide: each peer gathers every
    row for the attention and keeps its own. The step equals one
    process's."""
    (want,) = runs["one"]["dwc"]["steps"]
    for r, rank in enumerate(runs["ranks"]):
        (got,) = rank["dwc"]["steps"]
        _assert_step_equal(got, want, f"dwc_pe rank {r}")
    _assert_ranks_equal(runs["ranks"], "dwc")


def test_cls_step_with_mixup_on_the_full_mesh(runs):
    """The tiny classifier at 96² (stage 3: 2 and 1 rows) with ``ClsHead.fc``
    split: a CutMix and a Mixup step equal one process's, and the metric
    step's counts with a padded row are the global counts, not Y·S times
    them."""
    one = runs["one"]["cls"]
    for rank in runs["ranks"]:
        got = rank["cls"]
        for i, (a, want) in enumerate(zip(got["steps"], one["steps"])):
            _assert_step_equal(a, want, f"step {i}", first_step=i == 0)
            np.testing.assert_allclose(a["metrics"]["acc1"], want["metrics"]["acc1"], rtol=1e-6)
        np.testing.assert_array_equal(got["hits"], one["hits"])
    assert one["hits"][2] == CLS_VALID.sum()


def test_eval_step_on_the_full_mesh_equals_jax(runs):
    """``make_eval_step`` of the split model over {data: 1, model: 2,
    spatial: 2} returns the whole logits on every rank, equal to the JAX
    ``make_eval_step`` on the same mesh from the same variables."""
    want = runs["jax_eval"]
    assert want.shape == (2, 64, 64, W.NUM_CLASSES)
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["eval"], want, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(rank["eval"], runs["ranks"][0]["eval"])


def test_full_mesh_checkpoint_resumes_in_one_process_and_back(runs):
    """The trainer over {data: 1, model: 2, spatial: 2} with fsdp='model'
    for 2 iterations: its losses are the one-process run's and its
    ``ckpt_2`` holds the gathered whole model and AdamW moments, which one
    process resumes; and the reverse, one process's ``ckpt_2`` resumed by
    the four ranks: right after the restore each rank's gathered model is
    the one process's final model."""
    one = runs["one"]["train"]
    rank0 = runs["ranks"][0]["train"]
    for rank in runs["ranks"]:
        got = rank["train"]
        assert got["step"] == 2
        np.testing.assert_allclose(got["history"]["loss"], one["history"]["loss"], rtol=1e-4)
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
    ranks = [r["resume"] for r in runs["ranks"]]
    for r in ranks:
        assert r["step"] == 3 and np.isfinite(r["history"]["loss"][0])
        for name, v in one["state"].items():
            np.testing.assert_array_equal(r["restored"][name], v, err_msg=name)
        for name in ranks[0]["state"]:
            np.testing.assert_array_equal(r["state"][name], ranks[0]["state"][name], err_msg=name)
