"""The mesh's model axis on the CPU: four gloo ranks on ``{"data": 2,
"model": 2}`` against one process, and against the JAX package's step on
the same mesh with ``fsdp='model'``.

One module fixture starts four ranks (``tests/torch_parallel_worker.py``,
no JAX; rank d·2 + m is data coordinate d, model coordinate m) and, while
they run, computes the one-process references in this process (no process
group) and the JAX steps (the tiny UperNet's and ``MODES_A``'s) on a
``{"data": 2, "model": 2}`` mesh of the virtual CPU devices, their states
placed with ``shard_state(fsdp='model')``.
The tiny UperNet has offset groups (1, 2, 2, 4): stage 0's attention stays
whole at Y = 2 (its ``rpe_table`` held as a slice and gathered at use, as
the down convs: the JAX layout) and stages 1 and 3 split by group (stage 2
is an X block). Two more tiny UperNets with a 'D' block on every stage put
each position-bias mode on a split stage (``MODES_A``, ``MODES_B``).
Drop path and the heads' dropout are on (and in one step the backbone's
dropout, on the MLPs' split hidden units too), and data coordinate 1's
labels are 90% ignored. The tolerances are ``tests/test_torch_parallel.py``'s
(its docstring): loss rtol 1e-5, each leaf's gradient and parameter by the
per-leaf norm rule, BatchNorm statistics rtol 1e-4 / atol 1e-6, the IoU
counts within argmax near-ties.

The JAX step's ``grad_norm`` on this mesh is not a reference: XLA's CPU
partitioner doubles the gradient of every depthwise conv kernel it shards
over 'model' (``offset_dwc``, ``lpu``, ``mlp.dwc``; ``python
tests/jax_model_axis_grads.py`` prints each against the ``{"data": 2}``
program's), which AdamW's first step does not see (it divides by the
gradient's own scale) but the norm does. The split step's norm is held to
the port's one-process step instead, which ``tests/test_torch_parallel.py``
holds to the JAX ``{"data": 2}`` step.
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
from dat_segmentation_tpu.parallel import make_mesh
from dat_segmentation_tpu.parallel import make_train_step as jax_make_train_step
from dat_segmentation_tpu.parallel.mesh import fsdp_sharding, shard_batch, shard_state
from dat_segmentation_tpu.train import make_optimizer as jax_make_optimizer
from dat_segmentation_tpu.train import schedules as jsched
from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.configs import list_configs
from dat_segmentation_tpu_torch.parallel import resolve_mesh
from dat_segmentation_tpu_torch.parallel.mesh import mesh_sizes, rank_grid
from dat_segmentation_tpu_torch.parallel.model_axis import HELD, model_axis_plan
from dat_segmentation_tpu_torch.train import trainer_seg
from dat_segmentation_tpu_torch.train.checkpoint import CheckpointManager
from dat_segmentation_tpu_torch.utils.convert import convert_variables
from test_torch_parallel import (DRAWS, VALID, _assert_counts_close, _assert_step_equal,
                                 _grad_scale, _layout)
from torch_port_helpers import random_variables, with_modes

MESH = {"data": 2, "model": 2}
WORLD = 4
DROP_RATE = 0.1  # the backbone's dropout: the MLPs' masks on split hidden units
# every position-bias mode on a split stage (offset groups 2, 2, 4 at Y = 2),
# the continuous bias on stage 0 (one group: whole); fixed_pe on stage 2,
# where its table's resize has exact scales at 64² (tests/test_torch_pe_modes.py)
MODES_A = ("continuous", "dwc_pe", "fixed_pe", "log_cpb")
MODES_B = ("continuous", "no_off", "no_pe", "continuous")
MODES_ATTN_DROP = 0.1  # MODES_B's: the continuous bias's blocks run the composite too
# the plan's configurations: the presets, upn_tiny with each composite mode
# on every stage, and upn_tiny with attention dropout
PLAN_MODELS = tuple(list_configs()) + tuple(
    f"upn_tiny_160k_dp03_lr6:{m}" for m in ("dwc_pe", "fixed_pe", "log_cpb", "no_off", "no_pe",
                                             "attn_drop"))


def _modes_model(get_config_fn, modes, attn_drop=0.0, drop=0.0):
    """The tiny UperNet with a 'D' block on every stage, stage i's in
    ``modes[i]``, attention dropout ``attn_drop``, drop path and the heads'
    dropout ``drop``; either package's config."""
    cfg = W.tiny_seg(get_config_fn, drop=drop).model
    bb = dataclasses.replace(cfg.backbone, stage_spec=(("D",),) * 4, attn_drop_rate=attn_drop)
    return with_modes(dataclasses.replace(cfg, backbone=bb), modes)


def _held_k3_model():
    """The tiny UperNet with stage 1 an X block 256 wide with a 9x9 window
    (K3's gate holds at its 8² at 64²): its ``conv_attn`` (256·81 elements)
    is held as a slice, which K3 reads gathered."""
    cfg = W.tiny_seg(get_config, drop=0.0).model
    bb = dataclasses.replace(cfg.backbone, dims=(16, 256, 64, 128), window_sizes=(7, 9, 7, 7),
                             stage_spec=(("D",), ("X",), ("X",), ("D",)))
    return dataclasses.replace(cfg, backbone=bb)


def _jax_tp_step(variables, batch, model_cfg=None):
    """The JAX step on {"data": 2, "model": 2} with fsdp='model' from
    ``variables`` (of the tiny UperNet or ``model_cfg``): metrics, final
    state in the port's names."""
    jcfg = W.tiny_seg(jax_get_config, drop=0.0)
    jmodel = jax_build_model(jcfg.model if model_cfg is None else model_cfg)
    sched = jsched.warmup_poly_schedule(W.LR, 20, warmup_iters=0, warmup_ratio=1e-6, power=1.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(sched, params, weight_decay=0.01,
                            no_decay_keys=JaxOptimizerConfig().no_decay_keys)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                          tx=tx)
    mesh = make_mesh(MESH, devices=jax.devices("cpu")[:WORLD])
    state = shard_state(mesh, state, fsdp="model")
    step = jax_make_train_step(jmodel, mesh, aux_weight=0.4, num_classes=W.NUM_CLASSES,
                               compute_dtype=jnp.float32, fsdp="model", state=state)
    state, m = step(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
                    jax.random.PRNGKey(0))
    final = {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}
    return {k: np.asarray(v) for k, v in m.items()}, convert_variables(final)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis")
    data = _layout(tmp / "data")
    torch.manual_seed(0)
    seg_w, cls_w, jax_w = tmp / "seg.pt", tmp / "cls.pt", tmp / "jax_seg.pt"
    torch.save(build_model(W.tiny_seg(get_config).model, device="cpu").state_dict(), seg_w)
    torch.save(build_model(W.tiny_cls(get_config).model, device="cpu").state_dict(), cls_w)
    jcfg = W.tiny_seg(jax_get_config, drop=0.0)
    variables = random_variables(jax_build_model(jcfg.model), np.zeros((1, 64, 64, 3), np.float32),
                                 seed=3, train=False)
    torch.save(convert_variables(variables), jax_w)
    modes_a = _modes_model(get_config, MODES_A)
    modes_b = _modes_model(get_config, MODES_B, attn_drop=MODES_ATTN_DROP, drop=0.1)
    jax_a = _modes_model(jax_get_config, MODES_A)
    variables_a = random_variables(jax_build_model(jax_a), np.zeros((1, 64, 64, 3), np.float32),
                                   seed=4, train=False)
    a_w, b_w, k3_w = tmp / "modes_a.pt", tmp / "modes_b.pt", tmp / "held_k3.pt"
    torch.save(convert_variables(variables_a), a_w)
    torch.save(build_model(modes_b, device="cpu").state_dict(), b_w)
    torch.save(build_model(_held_k3_model(), device="cpu").state_dict(), k3_w)
    batches = W.seg_batches()
    rng = np.random.RandomState(5)
    cls_batch = {"image": rng.randn(4, 64, 64, 3).astype(np.float32),
                 "label": rng.randint(0, 10, 4).astype(np.int64)}
    one_proc_done = tmp / "w0.done"
    seg = dict(weights=seg_w, batches=batches)
    dropout = dict(weights=seg_w, batches=batches[:1], drop_rate=DROP_RATE)
    pallas = dict(weights=seg_w, batches=batches[:1], kernel_impl="pallas")
    tp = dict(mesh_shape=MESH, fsdp="model")
    on_a = dict(weights=a_w, model_cfg=modes_a, batches=batches[:1], round_trip=True, groups=True)
    on_b = dict(weights=b_w, model_cfg=modes_b, batches=batches[:1], groups=True)
    held_k3 = dict(weights=k3_w, model_cfg=_held_k3_model(), batches=batches[:1],
                   kernel_impl="pallas")
    tasks = [
        ("held_k3", "seg_steps", dict(held_k3, **tp)),
        ("modes_a", "seg_steps", dict(on_a, **tp)),
        ("modes_b", "seg_steps", dict(on_b, **tp)),
        ("tp", "seg_steps", dict(seg, groups=True, **tp)),
        ("tp_dropout", "seg_steps", dict(dropout, **tp)),
        ("tp_jax", "seg_steps", dict(weights=jax_w, batches=batches[:1], drop=0.0, **tp)),
        ("fsdp", "seg_steps", dict(seg, batches=batches[:1], mesh_shape=MESH, fsdp=True)),
        ("tp_ckpt", "seg_steps", dict(seg, batches=batches[:1], use_checkpoint=True, **tp)),
        ("tp_pallas", "seg_steps", dict(pallas, **tp)),
        ("cls", "cls_steps", dict(weights=cls_w, batch=cls_batch, draws=DRAWS, valid=VALID, **tp)),
        ("train", "train", dict(root=data, work=tmp / "w1", max_iters=2, drop=0.0, **tp)),
        ("resume", "train", dict(root=data, work=tmp / "w0", max_iters=3, resume=True,
                                 wait_for=one_proc_done, drop=0.0, **tp)),
    ]
    ctx = W.spawn(tmp / "ranks", tasks, world=WORLD)
    try:
        # the one-process references on the whole batches, meanwhile
        out = {"one": {
            "seg": W.seg_steps(0, 1, groups=True, **seg),
            "dropout": W.seg_steps(0, 1, **dropout),
            "pallas": W.seg_steps(0, 1, **pallas),
            "seg_jax": W.seg_steps(0, 1, weights=jax_w, batches=batches[:1], drop=0.0),
            "cls": W.cls_steps(0, 1, weights=cls_w, batch=cls_batch, draws=list(DRAWS),
                               valid=VALID),
            "train": W.train(0, 1, root=data, work=tmp / "w0", max_iters=2, drop=0.0),
            "modes_a": W.seg_steps(0, 1, **on_a),
            "modes_b": W.seg_steps(0, 1, **on_b),
            "held_k3": W.seg_steps(0, 1, **held_k3),
        }}
        one_proc_done.touch()  # the ranks resume from its ckpt_2
        out["jax"] = _jax_tp_step(variables, batches[0])
        out["jax_a"] = _jax_tp_step(variables_a, batches[0], jax_a)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    out["ranks"] = W.collect(ctx, tmp / "ranks", world=WORLD)
    out.update(tmp=tmp, data=data)
    return out


def _assert_ranks_equal(ranks, key):
    """Every rank's gathered state and metrics bit for bit rank 0's: the
    data replicas and the model peers' gathers agree."""
    first = ranks[0][key]["steps"]
    for rank in ranks[1:]:
        for a, b in zip(rank[key]["steps"], first):
            for name in b["state"]:
                np.testing.assert_array_equal(a["state"][name], b["state"][name], err_msg=name)
            for m in b["metrics"]:
                np.testing.assert_array_equal(a["metrics"][m], b["metrics"][m], err_msg=m)


def test_resolve_mesh_axes_and_refusals():
    """``{data, model}`` with fsdp in {False, True, 'data', 'model'} where
    the axes fit; fsdp='model' over a missing or size-1 axis raises
    ``ValueError`` (the JAX package's ``_check_fsdp_axis``), fsdp over the
    data axis without a process group ``ValueError``, a mesh that is not the
    group ``ValueError``. A spatial axis beside the model axis is a mesh of
    its own: larger than the group here (``ValueError``), rank (d·2 + m)·2 +
    s on {data: 2, model: 2, spatial: 2} (the JAX ``make_mesh`` order,
    ``rank_grid``)."""
    lay = resolve_mesh({"data": -1, "model": 1})
    assert (lay.data, lay.model, lay.model_axis) == (1, 1, None)
    assert resolve_mesh({"data": 1, "model": 1}, False).data == 1
    for shape, fsdp in (({"data": -1}, "model"), ({"data": 1, "model": 1}, "model"),
                        ({"data": -1}, True), ({"data": -1, "model": 1}, "data"),
                        ({"model": 1}, "spatial")):
        with pytest.raises(ValueError, match="fsdp axis"):
            resolve_mesh(shape, fsdp)
    for shape in ({"data": 1, "model": 2}, {"data": 2, "model": -1}, {"model": 2}):
        with pytest.raises(ValueError, match="processes"):
            resolve_mesh(shape)
    with pytest.raises(ValueError, match="group of 1 processes"):
        resolve_mesh({"data": -1, "model": 2, "spatial": 2}, "model")
    grid = rank_grid(mesh_sizes({"data": 2, "model": 2, "spatial": 2}, 8))
    assert all(grid[d, m, s] == (d * 2 + m) * 2 + s
               for d in range(2) for m in range(2) for s in range(2))


def test_plan_of_the_full_width_upernet_leaves_each_rank_half():
    """``model_axis_plan`` on the full-width ``upn_tiny_160k_dp03_lr6`` (no
    processes) leaves each of two model ranks at most the JAX rule's share
    of the parameter bytes (``fsdp_sharding`` over 'model', its 2^14
    minimum; both under 0.60); every 3x3 conv of the heads is split, stage
    0's one-group ``rpe_table`` and the down convs are held as slices, the
    whole leaves are named with their bytes, and every split dim divides
    by 2."""
    model = build_model(get_config("upn_tiny_160k_dp03_lr6").model, device="cpu")
    plan = model_axis_plan(model, 2)
    params = dict(model.named_parameters())
    assert set(plan) == set(model.state_dict())
    total = sum(p.numel() * 4 for p in params.values())
    local = sum(p.numel() * 4 / (2 if plan[n].dim is not None else 1) for n, p in params.items())
    jmesh = make_mesh({"model": 2}, devices=jax.devices("cpu")[:2])
    jax_local = sum(p.numel() * 4 / (2 if any(fsdp_sharding(jmesh, p, axis="model").spec) else 1)
                    for p in params.values())
    whole = sorted(((p.numel() * 4, n, plan[n].reason) for n, p in params.items()
                    if plan[n].dim is None), reverse=True)
    print(f"\nper rank {local / total:.4f} of {total} parameter bytes (JAX rule "
          f"{jax_local / total:.4f}); whole leaves, largest first:")
    for nbytes, name, why in whole[:12]:
        print(f"  {nbytes:>9} {name}: {why}")
    assert local <= jax_local and jax_local / total <= 0.60
    for name, entry in plan.items():
        t = model.state_dict()[name]
        if entry.dim is not None:
            assert t.shape[entry.dim] % 2 == 0, name
        if name.startswith("decode_head") and t.ndim == 4 and t.shape[-1] == 3:
            assert entry.dim == 0, name
    assert plan["backbone.stage_0.attn_1.proj_q.weight"].dim is None  # one offset group
    assert plan["backbone.stage_0.attn_1.rpe_table"].reason == HELD
    assert plan["backbone.down_conv_0.weight"].gathered
    assert plan["backbone.stage_3.attn_1.proj_out.weight"].dim == 1
    assert plan["backbone.stage_3.attn_1.offset_proj.weight"].partial


def test_seg_step_over_model_axis_equals_one_process(runs):
    """Two steps of the tiny UperNet over {data: 2, model: 2} with
    fsdp='model' equal the one-process steps on the global batch (loss,
    every leaf's gradient and parameter, BN statistics, grad norm, IoU
    counts), and the four ranks' gathered states agree bit for bit. Each
    rank's attention calls hold its data coordinate's rows and, in the split
    stages (1 and 3: 8² and 2² at 64²), half the offset groups."""
    one = runs["one"]["seg"]["steps"]
    want_groups = [(b // 2 // (1 if h == 16 else 2), h) for b, h in runs["one"]["seg"]["groups"]]
    assert [h for _, h in want_groups] == [16, 8, 2]
    for rank in runs["ranks"]:
        assert rank["tp"]["groups"] == want_groups
        for i, (a, want) in enumerate(zip(rank["tp"]["steps"], one)):
            noise = _assert_step_equal(a, want, f"step {i}", first_step=i == 0)
            assert noise <= {n for n in want["grads"] if "proj_k.bias" in n or "out_norm" in n}
            _assert_counts_close(a["metrics"], want["metrics"])
            np.testing.assert_allclose(a["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                                       rtol=1e-4)
    _assert_ranks_equal(runs["ranks"], "tp")
    assert one[1]["metrics"]["loss"] != one[0]["metrics"]["loss"]


def test_dropout_on_split_hidden_units_equals_one_process(runs):
    """A step with the backbone's dropout at 0.1: each MLP's mask on its split
    hidden units is this rank's slice of the one-process mask (the global
    batch's rows, the whole width), so the loss, every gradient, parameter
    and BN statistic are the one-process step's."""
    (want,) = runs["one"]["dropout"]["steps"]
    assert want["metrics"]["loss"] != runs["one"]["seg"]["steps"][0]["metrics"]["loss"]
    for rank in runs["ranks"]:
        (got,) = rank["tp_dropout"]["steps"]
        _assert_step_equal(got, want, "dropout step")
    _assert_ranks_equal(runs["ranks"], "tp_dropout")


def test_split_leaves_hold_half_along_their_plan_dim(runs):
    """Each split leaf (parameters, BN buffers) and its AdamW moments hold
    1/2 of the whole along the plan's dim, every whole leaf all of it."""
    whole = build_model(W.tiny_seg(get_config).model, device="cpu")
    plan = model_axis_plan(whole, 2)
    shapes = {n: tuple(t.shape) for n, t in whole.state_dict().items()}
    assert sum(e.dim is not None for e in plan.values()) > 40
    for rank in runs["ranks"]:
        local = rank["tp"]["local"]
        for name, entry in plan.items():
            want = list(shapes[name])
            if entry.dim is not None:
                want[entry.dim] //= 2
            assert local["leaves"][name] == tuple(want), name
            if name in local["moments"]:
                assert local["moments"][name] == tuple(want), name


def test_model_axis_step_equals_jax_step_on_the_same_mesh(runs):
    """The split step (drop 0: the RNGs differ) against the JAX
    ``make_train_step`` on {"data": 2, "model": 2} with fsdp='model', from
    the same variables on the same global batch: loss, grad norm, update
    ratio, IoU counts, BN statistics and every parameter whose gradient is
    not noise; the grad norm against the port's one-process step (the
    module docstring says why)."""
    metrics, want = runs["jax"]
    (one,) = runs["one"]["seg_jax"]["steps"]
    for rank in runs["ranks"]:
        (got,) = rank["tp_jax"]["steps"]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], one["metrics"]["grad_norm"],
                                   rtol=1e-4)
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


def _plan_model(name):
    preset, _, variant = name.partition(":")
    mc = get_config(preset).model
    if variant == "attn_drop":
        return dataclasses.replace(mc, backbone=dataclasses.replace(mc.backbone,
                                                                    attn_drop_rate=0.1))
    return with_modes(mc, (variant,) * 4) if variant else mc


@pytest.mark.parametrize("name", PLAN_MODELS)
def test_plan_holds_every_leaf_the_jax_rule_shards(name):
    """``model_axis_plan`` at full width (built on the meta device, no
    processes) at Y = 2 and 4: every leaf that the JAX ``fsdp_sharding(...,
    axis='model')`` shards has a plan dim, which divides by Y, and a rank's
    parameter bytes are at most the JAX rule's share; each split attention
    block's tables and ``rpe_dwc`` split with its groups, ``log_cpb``'s MLP
    whole and ``partial``."""
    with torch.device("meta"):
        model = build_model(_plan_model(name), device="meta")
    params = dict(model.named_parameters())
    total = sum(p.numel() for p in params.values())
    for Y in (2, 4):
        plan = model_axis_plan(model, Y)
        jmesh = make_mesh({"model": Y}, devices=jax.devices("cpu")[:Y])
        for n, t in model.state_dict(keep_vars=True).items():
            if any(fsdp_sharding(jmesh, t, axis="model").spec):
                assert plan[n].dim is not None, (name, Y, n, plan[n])
            if plan[n].dim is not None:
                assert t.shape[plan[n].dim] % Y == 0, (name, Y, n)
        local = sum(p.numel() / (Y if plan[n].dim is not None else 1) for n, p in params.items())
        jax_local = sum(p.numel() / (Y if any(fsdp_sharding(jmesh, p, axis="model").spec) else 1)
                        for p in params.values())
        assert local <= jax_local, (name, Y, local / total, jax_local / total)
        for prefix, mod in model.named_modules():
            if type(mod).__name__ == "DeformableAttention" and mod.n_groups % Y == 0:
                for leaf in ("proj_q.weight", "proj_out.weight", "rpe_table", "rpe_dwc.weight"):
                    e = plan.get(f"{prefix}.{leaf}")
                    assert e is None or (e.dim is not None and not e.gathered), (prefix, leaf)
                for leaf in ("cpb_fc1.weight", "cpb_fc2.weight", "offset_proj.weight"):
                    e = plan.get(f"{prefix}.{leaf}")
                    assert e is None or (e.partial and e.dim is None), (prefix, leaf)


@pytest.mark.parametrize("key", ["modes_a", "modes_b"])
def test_composite_modes_split_by_group_equal_one_process(runs, key):
    """A step of the tiny UperNets with every position-bias mode on a split
    stage (``MODES_A``: dwc_pe, fixed_pe, log_cpb; ``MODES_B``: no_off, no
    PE and the continuous bias under attention dropout 0.1, with drop path
    and the heads' dropout) over {data: 2, model: 2} with fsdp='model'
    equals the one-process step (loss, every gradient, parameter and BN
    statistic, grad norm, IoU counts), and the four ranks' gathered states
    agree bit for bit. Each rank holds half of each split block's
    projections and tables (``rpe_table`` by head, ``rpe_dwc`` by channel)
    and all of ``log_cpb``'s MLP; only stage 0's continuous bias in
    ``MODES_A`` takes K1's route (whole: one group), on the rank's rows."""
    (want,) = runs["one"][key]["steps"]
    model = build_model(_modes_model(get_config, MODES_A if key == "modes_a" else MODES_B),
                        device="cpu")
    plan = model_axis_plan(model, 2)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    for rank in runs["ranks"]:
        (got,) = rank[key]["steps"]
        _assert_step_equal(got, want, key)
        _assert_counts_close(got["metrics"], want["metrics"])
        np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                                   rtol=1e-4)
        assert rank[key]["groups"] == [(b // 2, h) for b, h in runs["one"][key]["groups"]]
        local = rank[key]["local"]["leaves"]
        for stage in (1, 2, 3):
            for leaf in ("proj_q.weight", "rpe_table", "rpe_dwc.weight"):
                name = f"backbone.stage_{stage}.attn_0.{leaf}"
                if name in shapes:
                    assert local[name][0] * 2 == shapes[name][0] and plan[name].dim == 0, name
            fc = f"backbone.stage_{stage}.attn_0.cpb_fc2.weight"
            if fc in shapes:
                assert local[fc] == shapes[fc] and plan[fc].partial, fc
    _assert_ranks_equal(runs["ranks"], key)
    assert runs["one"][key]["groups"] == ([(4, 16)] if key == "modes_a" else [])


def test_composite_modes_split_by_group_equal_jax_step(runs):
    """``MODES_A``'s step over {data: 2, model: 2} with fsdp='model' against
    the JAX ``make_train_step`` on the same mesh from the same variables:
    loss, BN statistics and every parameter whose gradient is not noise
    (not the grad norm: the module docstring says why)."""
    metrics, want = runs["jax_a"]
    for rank in runs["ranks"]:
        (got,) = rank["modes_a"]["steps"]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-5)
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


def test_held_leaves_and_moments_round_trip_into_one_process(runs):
    """The leaves held as slices (the JAX layout: the down convs, stage 0's
    one-group ``rpe_table``) hold half along their plan dim, as do their
    AdamW moments; ``full_state`` gathers every moment into the one-process
    format, equal to the one-process step's moments (the gradients' rule),
    and ``load_full_state`` of that state into a fresh split model and
    optimizer gives back each rank's parameters and moments bit for bit."""
    model = build_model(_modes_model(get_config, MODES_A), device="cpu")
    plan = model_axis_plan(model, 2)
    held = {n for n, e in plan.items() if e.gathered}
    assert {"backbone.down_conv_1.weight", "backbone.down_conv_2.weight",
            "backbone.stage_0.attn_0.rpe_table"} <= held
    one = runs["one"]["modes_a"]["moments"]
    total = {k: _grad_scale({n: m[k] for n, m in one.items()}) for k in ("exp_avg", "exp_avg_sq")}
    for rank in runs["ranks"]:
        got = rank["modes_a"]
        assert got["reloaded_equal"]
        for name in held:
            whole = tuple(model.state_dict()[name].shape)
            half = tuple(d // 2 if i == plan[name].dim else d for i, d in enumerate(whole))
            assert got["local"]["leaves"][name] == half == got["local"]["moments"][name], name
        assert set(got["moments"]) == set(one)
        for name, m in one.items():
            for k, w in m.items():
                assert got["moments"][name][k].shape == w.shape, (name, k)
                assert (np.linalg.norm(got["moments"][name][k] - w)
                        <= 1e-4 * np.linalg.norm(w) + 1e-6 * total[k]), (name, k)


def test_fsdp_over_data_on_the_two_axis_mesh_equals_one_process(runs):
    """fsdp=True on {data: 2, model: 2}: FSDP2 over each data group, the
    model peers computing the same thing; the step equals the one-process
    step (parameters, BN statistics, loss)."""
    want = runs["one"]["seg"]["steps"][0]
    for rank in runs["ranks"]:
        (got,) = rank["fsdp"]["steps"]
        _assert_step_equal(got, dict(want, grads={}), "fsdp step", grads=want["grads"])
    _assert_ranks_equal(runs["ranks"], "fsdp")


def test_use_checkpoint_over_model_axis_equals_one_process(runs):
    """With ``use_checkpoint`` (each stage recomputed in the backward, its
    collectives run again on every rank, drop path and dropout replayed)
    the split step equals the one-process step without it."""
    want = runs["one"]["seg"]["steps"][0]
    for rank in runs["ranks"]:
        (got,) = rank["tp_ckpt"]["steps"]
        _assert_step_equal(got, want, "checkpointed step")


def test_k3_on_gathered_weights_over_model_axis(runs):
    """``kernel_impl='pallas'`` under the model axis: K3's plain version
    gets the MLP weights gathered whole and contiguous, and the split step
    equals the one-process 'pallas' step (each shard's gradient its slice of
    the gathered weight's, not a sum)."""
    one = runs["one"]["pallas"]
    for rank in runs["ranks"]:
        got = rank["tp_pallas"]
        assert got["k3_whole_contiguous"] and all(got["k3_whole_contiguous"])
        assert len(got["k3_whole_contiguous"]) == len(one["k3_whole_contiguous"])
        for i, (a, want) in enumerate(zip(got["steps"], one["steps"])):
            _assert_step_equal(a, want, f"step {i}", first_step=i == 0)


def test_k3_reads_a_held_conv_attn_whole(runs):
    """``kernel_impl='pallas'`` where an X block's ``conv_attn`` is held as a
    slice (``_held_k3_model``): K3 (its plain version here) reads it
    gathered whole and contiguous (``layers.whole_param``: K3 calls no
    module), and the split step equals the one-process 'pallas' step."""
    plan = model_axis_plan(build_model(_held_k3_model(), device="cpu"), 2)
    assert plan["backbone.stage_1.conv_attn_0.weight"].gathered
    one = runs["one"]["held_k3"]
    assert one["k3_whole_contiguous"]
    for rank in runs["ranks"]:
        got = rank["held_k3"]
        assert all(got["k3_whole_contiguous"])
        assert len(got["k3_whole_contiguous"]) == len(one["k3_whole_contiguous"])
        (a,), (want,) = got["steps"], one["steps"]
        _assert_step_equal(a, want, "held conv_attn under K3")


def test_cls_step_with_mixup_over_model_axis(runs):
    """The tiny classifier with ``ClsHead.fc`` split: a CutMix and a Mixup
    step (pairs from the data axis's global batch) equal one process's, and
    the metric step's counts with a padded row are the global counts."""
    one = runs["one"]["cls"]
    for rank in runs["ranks"]:
        got = rank["cls"]
        for i, (a, want) in enumerate(zip(got["steps"], one["steps"])):
            _assert_step_equal(a, want, f"step {i}", first_step=i == 0)
            np.testing.assert_allclose(a["metrics"]["acc1"], want["metrics"]["acc1"], rtol=1e-6)
        np.testing.assert_array_equal(got["hits"], one["hits"])


def test_trainer_over_model_axis_val_counts_equal_one_process(runs):
    """``train_segmentation`` with fsdp='model' for 2 iterations (drop 0: the
    loader orders the global batch's rows by data coordinate, one process
    by item, and the masks follow the rows): its losses are the one-process
    run's, and its in-run val (a whole copy, two images over the data axis,
    counts summed over the data group) gives the counts one process gets
    from the same final weights: each image counted once, not once a model
    peer."""
    from dat_segmentation_tpu_torch import SegInferencer
    from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
    from dat_segmentation_tpu_torch.eval.evaluate import evaluate_dataset

    one = runs["one"]["train"]
    cfg = W.trainer_cfg(get_config, runs["data"], runs["tmp"] / "w1", drop=0.0)
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


def test_model_axis_checkpoint_resumes_in_one_process(runs):
    """The split run's ``ckpt_2`` holds the whole model and whole AdamW
    moments (the ranks' gathered state) and one process resumes from it."""
    rank0 = runs["ranks"][0]["train"]
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


def test_one_process_checkpoint_resumes_over_model_axis(runs):
    """The reverse: one process's ``ckpt_2`` resumed by the split ranks: right
    after the restore each rank's gathered model is the one process's final
    model, and the step from it leaves the ranks equal."""
    one = runs["one"]["train"]
    ranks = [r["resume"] for r in runs["ranks"]]
    assert one["step"] == 2 and all(r["step"] == 3 for r in ranks)
    for r in ranks:
        assert len(r["history"]["loss"]) == 1 and np.isfinite(r["history"]["loss"][0])
        for name, v in one["state"].items():
            np.testing.assert_array_equal(r["restored"][name], v, err_msg=name)
        for name in ranks[0]["state"]:
            np.testing.assert_array_equal(r["state"][name], ranks[0]["state"][name], err_msg=name)
