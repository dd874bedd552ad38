"""The PyTorch port's training pieces against the JAX package, on the CPU.

Losses, schedules, the no-decay grouping and the IoU counts against
``dat_segmentation_tpu/train``; then the trajectory: a small UperNet takes
three steps through the port's ``make_train_step`` and through the JAX
``make_train_step`` on a one-device CPU mesh, from the same weights and
batches, in float32 with drop path and dropout off. Tolerances are stated
at each check: float32 on both sides, summed in other orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.configs.schema import OptimizerConfig as JaxOptimizerConfig
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.parallel import TrainState as JaxTrainState
from dat_segmentation_tpu.parallel import make_mesh
from dat_segmentation_tpu.parallel import make_train_step as jax_make_train_step
from dat_segmentation_tpu.parallel.mesh import shard_batch, shard_state
from dat_segmentation_tpu.train import losses as jlosses
from dat_segmentation_tpu.train import metrics as jmetrics
from dat_segmentation_tpu.train import make_optimizer as jax_make_optimizer
from dat_segmentation_tpu.train import schedules as jsched
from dat_segmentation_tpu.train.optim import no_decay_mask
from dat_segmentation_tpu_torch import build_model, create_train_state, get_config, make_train_step
from dat_segmentation_tpu_torch.train import losses as tlosses
from dat_segmentation_tpu_torch.train import metrics as tmetrics
from dat_segmentation_tpu_torch.train import schedules as tsched
from dat_segmentation_tpu_torch.train.optim import no_decay_names
from torch_port_helpers import carry, random_variables, small_upernet

N_CLASSES = 8


def _logits_labels(shape=(2, 6, 7), classes=N_CLASSES, seed=0, ignore_frac=0.2):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, classes) * 3).astype(np.float32)
    labels = rng.randint(0, classes, shape).astype(np.int32)
    labels[rng.rand(*shape) < ignore_frac] = 255
    return logits, labels


# ------------------------------------------------------------------ losses --


@pytest.mark.parametrize("ignore_frac", [0.0, 0.3, 1.0], ids=["none", "some", "all"])
def test_cross_entropy_matches_jax(ignore_frac):
    """Mean over valid pixels; 0 when every pixel is ignored (rtol 1e-6)."""
    logits, labels = _logits_labels(ignore_frac=ignore_frac)
    ref = float(jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tlosses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if ignore_frac == 1.0:
        assert got == 0.0


def test_segmentation_loss_adds_weighted_aux():
    logits, labels = _logits_labels(seed=1)
    aux, _ = _logits_labels(seed=2)
    ref = jlosses.segmentation_loss(jnp.asarray(logits), jnp.asarray(aux), jnp.asarray(labels),
                                    aux_weight=0.4)
    got = tlosses.segmentation_loss(torch.from_numpy(logits), torch.from_numpy(aux),
                                    torch.from_numpy(labels), aux_weight=0.4)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_soft_target_and_label_smoothing_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(5, 10).astype(np.float32)
    targets = rng.dirichlet(np.ones(10), 5).astype(np.float32)
    labels = rng.randint(0, 10, 5)
    np.testing.assert_allclose(
        float(tlosses.soft_target_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))),
        float(jlosses.soft_target_cross_entropy(jnp.asarray(logits), jnp.asarray(targets))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.label_smoothing_cross_entropy(torch.from_numpy(logits),
                                                    torch.from_numpy(labels), smoothing=0.1)),
        float(jlosses.label_smoothing_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                    smoothing=0.1)),
        rtol=1e-6)


# --------------------------------------------------------------- schedules --


@pytest.mark.parametrize("policy", ["poly", "cosine"])
def test_schedules_match_jax(policy):
    """Step 0 (base_lr * warmup_ratio), inside warmup, its end, the decay
    and past the end (rtol 1e-6: float64 here, float32 in JAX)."""
    kw = dict(warmup_iters=10, warmup_ratio=1e-3, min_lr=1e-5)
    if policy == "poly":
        ref = jsched.warmup_poly_schedule(6e-5, 100, power=0.9, **kw)
        got = tsched.warmup_poly_schedule(6e-5, 100, power=0.9, **kw)
    else:
        ref = jsched.warmup_cosine_schedule(6e-5, 100, **kw)
        got = tsched.warmup_cosine_schedule(6e-5, 100, **kw)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, err_msg=str(step))
    np.testing.assert_allclose(got(0), 6e-5 * 1e-3, rtol=1e-12)


def test_preset_schedule_starts_at_warmup_ratio():
    cfg = get_config("upn_tiny_160k_dp03_lr6")
    sched = tsched.build_schedule(cfg)
    assert sched(0) == pytest.approx(6e-5 * 1e-6)
    assert sched(1500) == pytest.approx(6e-5)
    assert sched(160_000) == 0.0


# --------------------------------------------------------------- no-decay --


def test_no_decay_set_equals_jax_mask():
    """By name: the port's no-decay parameters are the JAX mask's False
    leaves (biases and the heads' BN parameters are decayed)."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmodel = jax_build_model(small_upernet(jax_get_config))
    shapes = jax.eval_shape(lambda a: jmodel.init(jax.random.PRNGKey(0), a, train=False), x)
    keys = JaxOptimizerConfig().no_decay_keys
    mask = no_decay_mask(shapes["params"], keys)
    jax_skip = {
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, decay in jax.tree_util.tree_flatten_with_path(mask)[0] if not decay
    }
    model = build_model(small_upernet(get_config), device="cpu")
    port_names = {n.rsplit(".", 1)[0] for n in no_decay_names(model, keys)}
    assert port_names == {n.rsplit(".", 1)[0] for n in jax_skip}
    assert not any("decode_head" in n and ".bn" in n for n in no_decay_names(model, keys))
    assert "backbone.stage_0.attn_0.rpe_table" in no_decay_names(model, keys)


# ----------------------------------------------------------------- metrics --


def test_intersect_and_union_equals_jax():
    rng = np.random.RandomState(4)
    pred = rng.randint(0, 6, (2, 9, 11))
    label = rng.randint(0, 6, (2, 9, 11))
    label[:, :3] = 255
    ref = jmetrics.intersect_and_union(jnp.asarray(pred), jnp.asarray(label), 6)
    got = tmetrics.intersect_and_union(torch.from_numpy(pred), torch.from_numpy(label), 6)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_streaming_iou_equals_jax():
    rng = np.random.RandomState(5)
    ours, theirs = tmetrics.StreamingIoU(5), jmetrics.StreamingIoU(5)
    for _ in range(3):
        pred, label = rng.randint(0, 5, (7, 8)), rng.randint(0, 5, (7, 8))
        label[0] = 255
        ours.update(pred, label)
        theirs.update(pred, label)
    np.testing.assert_array_equal(ours.inter, theirs.inter)
    np.testing.assert_array_equal(ours.union, theirs.union)
    assert ours.miou() == theirs.miou() and ours.accuracy() == theirs.accuracy()


# -------------------------------------------------------------- trajectory --

LR = 6e-4
STEPS = 3


def _train_cfg(get_config_fn, model_cfg):
    cfg = get_config_fn("upn_tiny_160k_dp03_lr6")
    return dataclasses.replace(
        cfg, model=model_cfg,
        optimizer=dataclasses.replace(cfg.optimizer, lr=LR),
        schedule=dataclasses.replace(cfg.schedule, warmup_iters=0, max_iters=20),
    )


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        label = rng.randint(0, N_CLASSES, (2, 64, 64)).astype(np.int32)
        label[:, :11, :7] = 255
        out.append({"image": rng.randn(2, 64, 64, 3).astype(np.float32), "label": label})
    return out


@pytest.fixture(scope="module")
def trajectories():
    batches = _batches()
    jcfg = _train_cfg(jax_get_config, small_upernet(jax_get_config))
    jmodel = jax_build_model(jcfg.model)
    variables = random_variables(jmodel, batches[0]["image"], seed=3, train=False)

    torch.manual_seed(0)
    pmodel = carry(build_model(small_upernet(get_config), device="cpu"), variables)
    pstate = create_train_state(pmodel, _train_cfg(get_config, small_upernet(get_config)))
    pstep = make_train_step(pmodel, num_classes=N_CLASSES, compute_dtype=torch.float32)
    port = []
    for b in batches:
        pstate, m = pstep(pstate, b)
        port.append({k: v.numpy() for k, v in m.items()})

    sched = jsched.warmup_poly_schedule(LR, 20, warmup_iters=0, warmup_ratio=1e-6, power=1.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(sched, params, weight_decay=0.01,
                            no_decay_keys=JaxOptimizerConfig().no_decay_keys)
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    # placed as the step's outputs are: the second step does not compile again
    jstate = shard_state(mesh, JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), tx=tx))
    jstep = jax_make_train_step(jmodel, mesh, aux_weight=0.4, num_classes=N_CLASSES,
                                compute_dtype=jnp.float32)
    ref = []
    for b in batches:
        jstate, m = jstep(jstate, shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}),
                          jax.random.PRNGKey(0))
        ref.append({k: np.asarray(v) for k, v in m.items()})
    final_ref = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    return port, ref, pmodel, final_ref, _first_grad_norms(variables, batches[0])


def _first_grad_norms(variables, batch):
    """||g|| of every parameter at the first step, in float64: the gradient
    with rounding taken out, to tell the leaves whose gradient is 0."""
    model = carry(build_model(small_upernet(get_config), device="cpu"), variables)
    model.double().train()
    logits, aux = model(torch.from_numpy(batch["image"]).double())
    loss = tlosses.segmentation_loss(logits, aux, torch.from_numpy(batch["label"]).long(),
                                     aux_weight=0.4)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: 0.0 if g is None else float(g.norm()) for n, g in zip(names, grads)}


def test_trajectory_loss_and_counts_match_jax(trajectories):
    """Loss per step to rtol 1e-5; the IoU counts of every step equal."""
    port, ref, _, _, _ = trajectories
    for i, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(p["grad_norm"], r["grad_norm"], rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(p["update_ratio"], r["update_ratio"], rtol=1e-3,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(p["inter"], r["inter"])
        np.testing.assert_array_equal(p["union"], r["union"])
    assert port[-1]["loss"] < port[0]["loss"]


# Leaves whose gradient is 0 in exact arithmetic: a shift of every key
# leaves the softmax as it is, and out_norm_0/1 feed only the 1x1 laterals,
# whose outputs a BatchNorm centres.
ZERO_GRAD_LEAVES = {
    "backbone.stage_0.attn_0.proj_k.bias", "backbone.stage_1.attn_1.proj_k.bias",
    "backbone.stage_2.attn_0.proj_k.bias", "backbone.stage_3.attn_0.proj_k.bias",
    "backbone.out_norm_0.bias", "backbone.out_norm_1.bias",
}


def test_trajectory_params_and_bn_stats_match_jax(trajectories):
    """After three AdamW steps, every parameter leaf and the BN running
    statistics.

    A leaf whose gradient is 0 (||g_leaf|| <= 1e-6 ||g|| in float64 at the
    first step) gets only float32 noise on both sides, and AdamW's first
    updates are about sign(g) * lr, so its elements step either way: those
    leaves, exactly ``ZERO_GRAD_LEAVES``, are left out. Every other leaf is
    held to ||p_port - p_jax|| <= 1e-4 ||p_jax||. The largest measured is
    7.2e-5, ``backbone.stage_0.attn_0.rpe_table``: entries at the edge of
    the sampled region get gradients near rounding and step either way.
    A leaf updated with a wrong gradient is off by about 1e-2. Running
    statistics within 1e-4."""
    from dat_segmentation_tpu_torch.utils.convert import convert_variables

    _, _, pmodel, final_ref, grad_norms = trajectories
    total = sum(g * g for g in grad_norms.values()) ** 0.5
    zero = {n for n, g in grad_norms.items() if g <= 1e-6 * total}
    assert zero == ZERO_GRAD_LEAVES
    want = convert_variables(final_ref)
    got = pmodel.state_dict()
    assert set(want) == set(got)
    off = {}
    for name, w in want.items():
        if name.endswith("num_batches_tracked") or name in zero:
            continue
        g, w = got[name].numpy(), w.numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        if rel > 1e-4:
            off[name] = rel
    assert not off, off


# ---------------------------------------------------------------- seeding --


def _dropping_run(seed):
    """Two steps of the small UperNet with drop path 0.3 and dropout 0.3
    from the train config's seed; also whether the global RNG moved."""
    torch.manual_seed(0)
    model_cfg = small_upernet(get_config, drop=0.3)
    model = build_model(model_cfg, device="cpu")
    cfg = dataclasses.replace(_train_cfg(get_config, model_cfg), seed=seed)
    state = create_train_state(model, cfg)
    step = make_train_step(model, num_classes=N_CLASSES, compute_dtype=torch.float32)
    rng = torch.get_rng_state()
    losses = [float(step(state, b)[1]["loss"]) for b in _batches()[:2]]
    return losses, model.state_dict(), torch.equal(rng, torch.get_rng_state())


def test_train_steps_are_reproducible_from_the_seed():
    """Drop path and dropout draw from the state's generator (cfg.seed + 1),
    never from the global RNG: the same seed gives the same losses and
    parameters, another seed other losses."""
    losses, sd, global_untouched = _dropping_run(0)
    again, sd_again, _ = _dropping_run(0)
    other, _, _ = _dropping_run(1)
    assert global_untouched
    assert losses == again
    assert all(torch.equal(sd[k], sd_again[k]) for k in sd)
    assert losses[0] != other[0]
