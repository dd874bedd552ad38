"""The mesh's spatial axis on the CPU: four gloo ranks on ``{"data": 2,
"spatial": 2}`` and ``{"data": 1, "spatial": 4}`` against one process, and
against the JAX package's step and eval step on the same meshes.

One module fixture starts four ranks (``tests/torch_parallel_worker.py``,
no JAX; on ``{data: X, spatial: S}`` rank d·S + s is data coordinate d,
spatial coordinate s, and each spatial peer keeps its rows of its data
coordinate's images) and, while they run, computes the one-process
references in this process (no process group) and the JAX steps on the
virtual CPU devices. The tiny UperNet at 64² has 16, 8, 4 and 2 rows at its
four stages: over four spatial peers stage 3 leaves two of them no row.
Drop path and the heads' dropout are on (the masks are drawn for the data
coordinate's whole rows), and data coordinate 1's labels are 90% ignored.
The classifier runs at 96², whose stage 3 has 3 rows: uneven shards (2 and
1) over two spatial peers. The tolerances are ``tests/test_torch_parallel.
py``'s (its docstring): loss rtol 1e-5, each leaf's gradient and parameter
by the per-leaf norm rule, BatchNorm statistics rtol 1e-4 / atol 1e-6, the
IoU counts within argmax near-ties; the eval logits against the JAX eval
step atol 1e-4 (float32, the two sides' resizes and convs summing in other
orders).
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
from dat_segmentation_tpu.parallel.mesh import shard_batch
from dat_segmentation_tpu.train import make_optimizer as jax_make_optimizer
from dat_segmentation_tpu.train import schedules as jsched
from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.ops.x_block import x_block_reference
from dat_segmentation_tpu_torch.parallel import resolve_mesh
from dat_segmentation_tpu_torch.parallel.mesh import ModelAxis, mesh_sizes, rank_grid
from dat_segmentation_tpu_torch.parallel.spatial import SLAB_MULTIPLE, Rows, slab_span
from dat_segmentation_tpu_torch.train import trainer_seg
from dat_segmentation_tpu_torch.train.checkpoint import CheckpointManager
from dat_segmentation_tpu_torch.utils.convert import convert_variables
from test_torch_parallel import DRAWS, _assert_counts_close, _assert_step_equal, _layout
from torch_port_helpers import random_variables, small_fpn, with_modes

DP_SP = {"data": 2, "spatial": 2}
SP4 = {"data": 1, "spatial": 4}
WORLD = 4
CLS_SIZE = 96  # stage 3: 3 rows over two spatial peers
CLS_VALID = np.array([True, True, True, False])  # data coordinate 1's last row padded
FPN_MODES = ("dwc_pe", "continuous", "log_cpb", "no_off")


def _fpn_modes():
    """The small SemanticFPN with a composite position-bias mode on stages
    0, 2 and 3 and attention dropout 0.1 (every block's composite in
    training, its dropout on the caller's generator)."""
    cfg = with_modes(small_fpn(get_config, num_classes=W.NUM_CLASSES), FPN_MODES)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                 attn_drop_rate=0.1))


def _jax_state(variables):
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
    return jmodel, state


def _jax_spatial_step(variables, batch):
    """The JAX step on {"data": 2, "spatial": 2} (images and labels sharded
    over H too) from ``variables``: metrics, final state in the port's
    names."""
    jmodel, state = _jax_state(variables)
    mesh = make_mesh(DP_SP, devices=jax.devices("cpu")[:WORLD])
    step = jax_make_train_step(jmodel, mesh, aux_weight=0.4, num_classes=W.NUM_CLASSES,
                               compute_dtype=jnp.float32)
    state, m = step(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
                    jax.random.PRNGKey(0))
    final = {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}
    return {k: np.asarray(v) for k, v in m.items()}, convert_variables(final)


def _jax_eval(variables, image):
    """The JAX ``make_eval_step`` on {"data": 1, "spatial": 4} (16 rows a
    device at 64²)."""
    jmodel, state = _jax_state(variables)
    mesh = make_mesh(SP4, devices=jax.devices("cpu")[:WORLD])
    img = shard_batch(mesh, {"image": jnp.asarray(image)})["image"]
    assert all(s.data.shape == (image.shape[0], 16, 64, 3) for s in img.addressable_shards)
    fwd = jax_make_eval_step(jmodel, mesh, compute_dtype=jnp.float32)
    return np.asarray(fwd(state.params, state.batch_stats, img))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_axis")
    data = _layout(tmp / "data")
    torch.manual_seed(0)
    seg_w, cls_w, jax_w = tmp / "seg.pt", tmp / "cls.pt", tmp / "jax_seg.pt"
    torch.save(build_model(W.tiny_seg(get_config).model, device="cpu").state_dict(), seg_w)
    fpn_w = tmp / "fpn.pt"
    torch.save(build_model(_fpn_modes(), device="cpu").state_dict(), fpn_w)
    torch.save(build_model(W.tiny_cls(get_config).model, device="cpu").state_dict(), cls_w)
    jcfg = W.tiny_seg(jax_get_config, drop=0.0)
    variables = random_variables(jax_build_model(jcfg.model), np.zeros((1, 64, 64, 3), np.float32),
                                 seed=3, train=False)
    torch.save(convert_variables(variables), jax_w)
    batches = W.seg_batches()
    rng = np.random.RandomState(5)
    cls_batch = {"image": rng.randn(4, CLS_SIZE, CLS_SIZE, 3).astype(np.float32),
                 "label": rng.randint(0, 10, 4).astype(np.int64)}
    image = rng.randn(2, 64, 64, 3).astype(np.float32)
    one_step = dict(weights=seg_w, batches=batches[:1])
    # two images (one 90% ignored) over four spatial peers: each gathers
    # the rows for the attention
    fpn = dict(weights=fpn_w, model_cfg=_fpn_modes(),
               batches=[{k: v[1:3] for k, v in batches[0].items()}])
    # 80²: stages of 20, 10, 5 and 3 rows, so the heads resize 3 -> 5 and
    # 3 -> 20 rows (no whole factor) and the stride-2 convs change layouts
    label = rng.randint(0, W.NUM_CLASSES, (4, 80, 80)).astype(np.int32)
    label[2:][rng.rand(2, 80, 80) < 0.9] = 255
    odd = dict(weights=seg_w, batches=[{"image": rng.randn(4, 80, 80, 3).astype(np.float32),
                                        "label": label}])
    tasks = [
        ("dp_sp", "seg_steps", dict(one_step, groups=True, mesh_shape=DP_SP)),
        ("dp_sp_jax", "seg_steps", dict(weights=jax_w, batches=batches[:1], drop=0.0,
                                        mesh_shape=DP_SP)),
        ("sp4", "seg_steps", dict(one_step, groups=True, mesh_shape=SP4, drop_rate=0.1)),
        ("sp4_eval", "eval_logits", dict(weights=jax_w, image=image, mesh_shape=SP4)),
        ("pallas", "seg_steps", dict(one_step, kernel_impl="pallas", mesh_shape=DP_SP)),
        ("fsdp_ckpt", "seg_steps", dict(one_step, fsdp=True, use_checkpoint=True,
                                        mesh_shape=DP_SP)),
        ("sp4_ckpt", "seg_steps", dict(one_step, use_checkpoint=True, mesh_shape=SP4)),
        ("cls", "cls_steps", dict(weights=cls_w, batch=cls_batch, draws=DRAWS, valid=CLS_VALID,
                                  mesh_shape=DP_SP)),
        ("train", "train", dict(root=data, work=tmp / "w1", max_iters=2, mesh_shape=SP4)),
        ("fpn_modes", "seg_steps", dict(fpn, mesh_shape=SP4)),
        ("odd", "seg_steps", dict(odd, mesh_shape=DP_SP)),
    ]
    ctx = W.spawn(tmp / "ranks", tasks, world=WORLD)
    try:
        # the one-process references on the whole batches, meanwhile
        out = {"one": {
            "seg": W.seg_steps(0, 1, groups=True, **one_step),
            "dropout": W.seg_steps(0, 1, drop_rate=0.1, **one_step),
            "pallas": W.seg_steps(0, 1, kernel_impl="pallas", **one_step),
            "cls": W.cls_steps(0, 1, weights=cls_w, batch=cls_batch, draws=list(DRAWS),
                               valid=CLS_VALID),
            "train": W.train(0, 1, root=data, work=tmp / "w0", max_iters=2),
            "fpn_modes": W.seg_steps(0, 1, **fpn),
            "odd": W.seg_steps(0, 1, **odd),
        }}
        out["jax"] = _jax_spatial_step(variables, batches[0])
        out["jax_eval"] = _jax_eval(variables, image)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    out["ranks"] = W.collect(ctx, tmp / "ranks", world=WORLD)
    out.update(tmp=tmp, data=data)
    return out


def _assert_ranks_equal(ranks, key):
    """Every rank's state and metrics bit for bit rank 0's: the gradients
    are summed over data × spatial, so the replicas stay equal."""
    first = ranks[0][key]["steps"]
    for rank in ranks[1:]:
        for a, b in zip(rank[key]["steps"], first):
            for name in b["state"]:
                np.testing.assert_array_equal(a["state"][name], b["state"][name], err_msg=name)
            for m in b["metrics"]:
                np.testing.assert_array_equal(a["metrics"][m], b["metrics"][m], err_msg=m)


def _noise_ok(noise, grads):
    """The leaves whose gradient is 0 in exact arithmetic: ``proj_k``'s
    bias (softmax is shift-invariant) and the LayerNorms before a conv and
    a BatchNorm (``out_norm``'s bias: the BatchNorm subtracts the mean)."""
    return noise <= {n for n in grads if "proj_k.bias" in n or "out_norm" in n}


def test_resolve_mesh_spatial_layouts_and_refusals():
    """Without a group a spatial axis above 1 is a mesh larger than the group
    (``ValueError`` naming the processes), ``spatial: 1`` is the data axis,
    another axis name above 1 raises ``NotImplementedError``. The model axis
    beside the spatial one, and fsdp='spatial', are meshes of their own: the
    ranks' places (``rank_grid``, the JAX ``make_mesh`` order) on {data: 1,
    model: 2, spatial: 2} and, spatial first, {data: 1, spatial: 2, model:
    2}; fsdp='spatial' where the mesh has no spatial axis above 1 raises the
    JAX package's ``ValueError``, on a spatial axis the group-size one."""
    assert resolve_mesh({"data": -1, "spatial": 1}).spatial_axis is None
    for shape in ({"data": -1, "spatial": 2}, {"data": 1, "spatial": 2}, {"spatial": -1,
                                                                          "data": 2}):
        with pytest.raises(ValueError, match="processes"):
            resolve_mesh(shape, False)
    assert rank_grid(mesh_sizes({"data": 1, "model": 2, "spatial": 2}, 4)).tolist() == [
        [[0, 1], [2, 3]]]
    assert rank_grid(mesh_sizes({"data": 1, "spatial": 2, "model": 2}, 4)).tolist() == [
        [[0, 2], [1, 3]]]
    with pytest.raises(ValueError, match="processes"):
        resolve_mesh({"data": 1, "model": 2, "spatial": 2})
    with pytest.raises(NotImplementedError, match="'sequence'"):
        resolve_mesh({"data": 1, "sequence": 2})
    with pytest.raises(ValueError, match="processes"):
        resolve_mesh({"data": 1, "spatial": 2}, "spatial")
    for shape in ({"data": -1}, {"data": 1, "spatial": 1}):
        with pytest.raises(ValueError, match="fsdp axis 'spatial'"):
            resolve_mesh(shape, "spatial")


@pytest.mark.parametrize("H,S", [(64, 2), (32, 4), (16, 4), (24, 2), (8, 4)])
@pytest.mark.parametrize("mode", ["x_lpu", "mlp"])
def test_k3_slab_keeps_exact_rows(H, S, mode):
    """K3 (its plain version) on each peer's slab (``slab_span``: its rows
    and the halo K3's zero padding spoils, clipped to the image and grown to
    K3's 8-row multiple) gives exactly those rows of K3 on the whole map:
    the X block with its LPU reads 1 + 3 + 1 rows each side, the MLP 1."""
    torch.manual_seed(H + S)
    C, E, k = 32, 128, 7
    x = torch.randn(2, H, 8, C, dtype=torch.float64)
    p = {n: torch.randn(*s, dtype=torch.float64) * 0.2 for n, s in dict(
        w3=(C, 1, 3, 3), b3=(C,), w7=(C, 1, k, k), b7=(C,), g=(C,), be=(C,), wf1=(E, C),
        bf1=(E,), wd=(E, 1, 3, 3), bd=(E,), wf2=(C, E), bf2=(C,)).items()}
    lpu = mode == "x_lpu"
    if not lpu:
        p.update(w3=None, b3=None, w7=None, b7=None)
    halo = 5 if lpu else 1
    whole = x_block_reference(x, *p.values(), with_lpu=lpu)
    for s in range(S):
        rows = Rows(H, ModelAxis(s, S, None))
        a, b = slab_span(rows, s, halo)
        assert 0 <= a <= rows.lo and rows.hi <= b <= H and (b - a) % SLAB_MULTIPLE == 0
        got = x_block_reference(x[:, a:b].contiguous(), *p.values(), with_lpu=lpu)
        torch.testing.assert_close(got[:, rows.lo - a:rows.hi - a], whole[:, rows.lo:rows.hi],
                                   rtol=1e-12, atol=1e-12)


def test_seg_step_over_data_and_spatial_equals_one_process(runs):
    """One step of the tiny UperNet over {data: 2, spatial: 2} (drop path and
    the heads' dropout on, data coordinate 1's labels 90% ignored) equals the
    one-process step on the global batch (loss, every leaf's gradient and
    parameter, BN statistics, grad norm, IoU counts), and the four ranks
    agree bit for bit. Each rank's attention runs batch-parallel on whole
    maps: K1 calls of its one batch row (its data coordinate's two over two
    spatial peers) at the stages' full heights."""
    (want,) = runs["one"]["seg"]["steps"]
    want_groups = [(b // 4, h) for b, h in runs["one"]["seg"]["groups"]]
    assert [h for _, h in want_groups] == [16, 8, 2]
    for rank in runs["ranks"]:
        assert rank["dp_sp"]["groups"] == want_groups
        (got,) = rank["dp_sp"]["steps"]
        assert _noise_ok(_assert_step_equal(got, want, "dp x sp step"), want["grads"])
        _assert_counts_close(got["metrics"], want["metrics"])
        np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                                   rtol=1e-4)
    _assert_ranks_equal(runs["ranks"], "dp_sp")


def test_spatial_step_equals_jax_step_on_the_same_mesh(runs):
    """The {data: 2, spatial: 2} step (drop 0: the RNGs differ) against the
    JAX ``make_train_step`` on the same mesh from the same variables and
    global batch: loss, grad norm, update ratio, IoU counts, BN statistics
    and every parameter whose gradient is not noise."""
    metrics, want = runs["jax"]
    for rank in runs["ranks"]:
        (got,) = rank["dp_sp_jax"]["steps"]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], metrics["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["update_ratio"], metrics["update_ratio"],
                                   rtol=1e-3)
        _assert_counts_close(got["metrics"], metrics)
        total = np.sqrt(sum(np.sum(np.square(g)) for g in got["grads"].values()))
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            g = got["state"][name]
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
            elif np.linalg.norm(got["grads"][name]) > 1e-6 * total:
                rel = np.linalg.norm(g - w.numpy()) / np.linalg.norm(w.numpy())
                assert rel <= 1e-4, (name, rel)


def test_four_spatial_peers_with_empty_ranks_equal_one_process(runs):
    """{data: 1, spatial: 4}: stage 3's 2 rows leave ranks 2 and 3 none (a
    conv there convolves a row it drops), stage 2 has one row a rank. A step
    with the backbone's dropout on too (the MLPs' masks: each peer's rows of
    the whole mask) equals the one-process step; each rank's attention takes
    one of the two batch rows."""
    (want,) = runs["one"]["dropout"]["steps"]
    want_groups = [(b // 4, h) for b, h in runs["one"]["seg"]["groups"]]
    for rank in runs["ranks"]:
        assert rank["sp4"]["groups"] == want_groups
        (got,) = rank["sp4"]["steps"]
        assert _noise_ok(_assert_step_equal(got, want, "sp4 step"), want["grads"])
        _assert_counts_close(got["metrics"], want["metrics"])
    _assert_ranks_equal(runs["ranks"], "sp4")


def test_fpn_and_composite_attention_on_gathered_rows(runs):
    """The small SemanticFPN (its neck's nearest top-down path and its
    head's bilinear x2 chains on row shards) with composite attention
    (dwc_pe, log_cpb, no_off, the continuous bias under attention dropout
    0.1), two images over {data: 1, spatial: 4}: S does not divide the
    batch, so each peer runs the attention on every row of both images
    and keeps its own; the step equals one process's, dropout masks
    included, with no K1 launch."""
    (want,) = runs["one"]["fpn_modes"]["steps"]
    assert want["launches"] == (0, 0)
    for rank in runs["ranks"]:
        (got,) = rank["fpn_modes"]["steps"]
        assert got["launches"] == (0, 0)
        _assert_step_equal(got, want, "fpn modes step")
    _assert_ranks_equal(runs["ranks"], "fpn_modes")


def test_resizes_without_a_whole_factor_on_row_shards(runs):
    """The tiny UperNet at 80² over {data: 2, spatial: 2}: stage 3's 3 rows
    (2 and 1 a peer) resized to stage 2's 5 and stage 0's 20 by the
    separable row-wise resize, the stride-2 convs fetching rows on uneven
    layouts; the step equals one process's."""
    (want,) = runs["one"]["odd"]["steps"]
    for rank in runs["ranks"]:
        (got,) = rank["odd"]["steps"]
        assert _noise_ok(_assert_step_equal(got, want, "80² step"), want["grads"])
        _assert_counts_close(got["metrics"], want["metrics"], pixels=4 * 80 * 80)
    _assert_ranks_equal(runs["ranks"], "odd")


def test_eval_step_over_four_spatial_peers_equals_jax(runs):
    """``make_eval_step`` over {data: 1, spatial: 4} (ranks without a row at
    stage 3) returns the whole logits on every rank, equal to the JAX
    ``make_eval_step`` on the same mesh (``tests/test_parallel.py``'s
    spatial eval) from the same variables."""
    want = runs["jax_eval"]
    assert want.shape == (2, 64, 64, W.NUM_CLASSES)
    for rank in runs["ranks"]:
        got = rank["sp4_eval"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got, runs["ranks"][0]["sp4_eval"])


def test_k3_on_halo_slabs_equals_one_process(runs):
    """``kernel_impl='pallas'`` over {data: 2, spatial: 2}: K3's plain version
    runs on each peer's slab, as many times as in one process, and the step
    equals the one-process 'pallas' step."""
    one = runs["one"]["pallas"]
    for rank in runs["ranks"]:
        got = rank["pallas"]
        assert len(got["k3_whole_contiguous"]) == len(one["k3_whole_contiguous"]) > 0
        _assert_step_equal(got["steps"][0], one["steps"][0], "pallas step")
    _assert_ranks_equal(runs["ranks"], "pallas")


def test_fsdp_and_checkpoint_over_spatial_equal_one_process(runs):
    """fsdp=True with ``use_checkpoint`` on {data: 2, spatial: 2} (FSDP2 over
    the data groups, the sharded gradients summed over the spatial peers,
    each stage recomputed with its exchanges in the forward's order), and
    ``use_checkpoint`` on {data: 1, spatial: 4}, equal the one-process step."""
    (want,) = runs["one"]["seg"]["steps"]
    for rank in runs["ranks"]:
        (got,) = rank["fsdp_ckpt"]["steps"]
        assert rank["fsdp_ckpt"]["sharded"]["local"] != rank["fsdp_ckpt"]["sharded"]["shape"]
        _assert_step_equal(got, dict(want, grads={}), "fsdp step", grads=want["grads"])
        (got,) = rank["sp4_ckpt"]["steps"]
        _assert_step_equal(got, want, "checkpointed step")
    _assert_ranks_equal(runs["ranks"], "fsdp_ckpt")
    _assert_ranks_equal(runs["ranks"], "sp4_ckpt")


def test_cls_step_with_mixup_on_uneven_shards(runs):
    """The tiny classifier at 96² over {data: 2, spatial: 2} (stage 3's 3 rows:
    2 and 1): a CutMix step (the box's rows on each shard, lambda from the
    whole box) and a Mixup step equal one process's (the replicated logits'
    loss weighted by 1/S), and the metric step's counts with a padded row are
    the global counts, not S times them."""
    one = runs["one"]["cls"]
    for rank in runs["ranks"]:
        got = rank["cls"]
        for i, (a, want) in enumerate(zip(got["steps"], one["steps"])):
            _assert_step_equal(a, want, f"step {i}", first_step=i == 0)
            np.testing.assert_allclose(a["metrics"]["acc1"], want["metrics"]["acc1"], rtol=1e-6)
        np.testing.assert_array_equal(got["hits"], one["hits"])
    assert one["hits"][2] == CLS_VALID.sum()
    _assert_ranks_equal(runs["ranks"], "cls")


def test_trainer_over_spatial_axis_equals_one_process(runs):
    """``train_segmentation`` over {data: 1, spatial: 4} for 2 iterations
    (drop path and dropout on: one data coordinate loads the batch one
    process loads): its losses are the one-process run's, its in-run val
    (per process on whole images, counts summed over the data group) gives
    the counts one process gets from the same final weights, each image
    counted once, not once a spatial peer; and the ranks end equal."""
    from dat_segmentation_tpu_torch import SegInferencer
    from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
    from dat_segmentation_tpu_torch.eval.evaluate import evaluate_dataset

    one = runs["one"]["train"]
    cfg = W.trainer_cfg(get_config, runs["data"], runs["tmp"] / "w1")
    torch.manual_seed(0)
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           runs["ranks"][0]["train"]["state"].items()})
    inf = SegInferencer(model, num_classes=cfg.model.num_classes, mode=cfg.model.test_mode,
                        compute_dtype=torch.float32, device="cpu")
    # as each rank ran it: one image a batch, one intra-op thread (an argmax
    # near-tie may round the other way otherwise)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = evaluate_dataset(inf, ADE20KDataset(str(runs["data"]), "val", crop_size=(64, 64)),
                                num_classes=cfg.model.num_classes, max_images=2, batch_size=1,
                                verbose=False)
    finally:
        torch.set_num_threads(threads)
    for rank in runs["ranks"]:
        got = rank["train"]
        assert got["step"] == 2 and len(got["vals"]) == 1 and got["vals"][0]["num_images"] == 2
        assert got["vals"][0]["inter"] == want["inter"] and got["vals"][0]["union"] == want["union"]
        np.testing.assert_allclose(got["history"]["loss"], one["history"]["loss"], rtol=1e-4)
        for name in got["state"]:
            np.testing.assert_array_equal(got["state"][name],
                                          runs["ranks"][0]["train"]["state"][name], err_msg=name)
    assert "ckpt_2" in runs["ranks"][0]["train"]["ckpts"]


def test_spatial_checkpoint_resumes_in_one_process(runs):
    """The spatial run's ``ckpt_2`` holds rank 0's model in the one-process
    format, and one process resumes from it."""
    rank0 = runs["ranks"][0]["train"]
    work = runs["tmp"] / "w1"
    saved = CheckpointManager(work / "dp").restore(2, map_location="cpu")
    for name, v in rank0["state"].items():
        np.testing.assert_array_equal(saved["model"][name].numpy(), v, err_msg=name)
    cfg = W.trainer_cfg(get_config, runs["data"], work)
    state, hist = trainer_seg.train_segmentation(cfg, device="cpu", max_iters=3, resume=True,
                                                 eval_max_images=1)
    assert state.step == 3 and len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
