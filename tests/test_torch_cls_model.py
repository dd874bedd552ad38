"""The port's classifier against the JAX package's, on the CPU.

A small classifier (``cls_tiny_imagenet`` cut to a few narrow blocks with a
'D' block in every stage, 10 classes, drop path 0) is built in both
packages; JAX variables drawn from a numpy seed are carried into the port
(``utils/convert.py``). Held to the JAX package, float32:

* ``ClsHead`` and ``DatClassifier`` logits at 128² (every stage side a
  multiple of its stride, none 1 wide): atol 1e-4, as the segmentors';
* ``convert_classifier`` and the JAX converter on a reference-schema dict
  written by ``tools/reference_schema.py``: equal;
* ``topk_accuracy``, and ``make_cls_metric_step``'s counts with a padded
  ``valid`` mask: equal;
* ``mixup_cutmix`` given the draws the JAX function takes from its key
  (recomputed here by the same splits): images equal, targets to 1e-7;
* ``weight_stats_on_device`` and ``grad_update_ratio``: to rtol 1e-5;
* three train steps (64², batch 4) against the JAX ``make_train_step(
  task='cls')``, without mixup and with mixup replaying the JAX step's own
  draws: loss to rtol 1e-5, ``acc1`` equal, ``grad_norm`` to 1e-4 and
  ``update_ratio`` to 1e-3, as the seg step's test holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.data.mixup import mixup_cutmix as jax_mixup_cutmix
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.models import heads as jh
from dat_segmentation_tpu.parallel import TrainState as JaxTrainState
from dat_segmentation_tpu.parallel import make_cls_metric_step as jax_make_cls_metric_step
from dat_segmentation_tpu.parallel import make_mesh
from dat_segmentation_tpu.parallel import make_train_step as jax_make_train_step
from dat_segmentation_tpu.parallel.mesh import shard_batch, shard_state
from dat_segmentation_tpu.train import make_optimizer as jax_make_optimizer
from dat_segmentation_tpu.train import schedules as jsched
from dat_segmentation_tpu.train.metrics import topk_accuracy as jax_topk_accuracy
from dat_segmentation_tpu.utils import logging as jax_logging
from dat_segmentation_tpu.utils.torch_convert import convert_classifier as jax_convert_classifier
from dat_segmentation_tpu_torch import build_model, create_train_state, get_config, make_train_step
from dat_segmentation_tpu_torch.data.mixup import (MixupDraws, MixupSampler, cutmix_box,
                                                   mixup_cutmix)
from dat_segmentation_tpu_torch.models import heads as th
from dat_segmentation_tpu_torch.models.segmentor import DatClassifier
from dat_segmentation_tpu_torch.tools.reference_schema import to_reference
from dat_segmentation_tpu_torch.train.metrics import topk_accuracy
from dat_segmentation_tpu_torch.train.train_step import make_cls_metric_step
from dat_segmentation_tpu_torch.utils import torch_convert as tc
from dat_segmentation_tpu_torch.utils import logging as port_logging
from dat_segmentation_tpu_torch.utils.convert import convert_variables
from torch_port_helpers import carry, jax_apply, port_apply, random_variables, small_classifier

N_CLASSES = 10
MODEL_ATOL = 1e-4
LR = 2e-4
STEPS = 3


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(small_classifier(jax_get_config))
    x = np.random.RandomState(1).randn(2, 128, 128, 3).astype(np.float32)
    variables = random_variables(jmodel, x, seed=3, train=False)
    torch.manual_seed(0)
    pmodel = carry(build_model(small_classifier(get_config), device="cpu"), variables)
    return jmodel, variables, pmodel, x


def test_cls_head_matches_jax():
    feats = [np.random.RandomState(i).randn(2, s, s, c).astype(np.float32)
             for i, (s, c) in enumerate([(8, 16), (4, 32), (2, 48)])]
    jmod = jh.ClsHead(num_classes=7)
    variables = random_variables(jmod, feats, seed=5)
    port = carry(th.ClsHead(48, 7), variables)
    ref = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats]).numpy()
    assert got.shape == ref.shape == (2, 7)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_classifier_logits_match_jax(pair):
    jmodel, variables, pmodel, x = pair
    assert isinstance(pmodel, DatClassifier)
    ref = np.asarray(jax_apply(jmodel, variables, x, train=False))
    got = port_apply(pmodel, x).numpy()
    assert got.shape == ref.shape == (2, N_CLASSES)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODEL_ATOL)


def test_convert_classifier_matches_the_jax_converter(pair):
    """Both routes from a reference-schema dict give the model's tensors:
    the port's table, and the JAX converter then ``convert_variables``."""
    _, _, pmodel, _ = pair
    cfg = small_classifier(get_config)
    want = pmodel.state_dict()
    ref = to_reference(want, cfg)
    assert "head.norm.norm.weight" in ref and ref["head.fc.weight"].shape == (N_CLASSES, 64)
    routes = {
        "port": tc.convert_classifier(ref, cfg),
        "jax": convert_variables(jax_convert_classifier({k: v.numpy() for k, v in ref.items()},
                                                        small_classifier(jax_get_config))),
    }
    for name, got in routes.items():
        assert set(got) == set(want), name
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)


def test_topk_accuracy_matches_jax():
    """Integer logits, so that ties occur; hard and soft labels."""
    rng = np.random.RandomState(4)
    logits = rng.randint(0, 4, (64, N_CLASSES)).astype(np.float32)
    hard = rng.randint(0, N_CLASSES, 64)
    soft = np.eye(N_CLASSES, dtype=np.float32)[hard] * 0.7 + 0.03
    for labels in (hard, soft):
        ref = jax_topk_accuracy(jnp.asarray(logits), jnp.asarray(labels))
        got = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
        assert set(got) == {1, 5}
        for k in (1, 5):
            assert float(got[k]) == float(ref[k]), k


def test_cls_metric_step_counts_match_jax(pair):
    """[hits1, hits5, total] with the last row padded out; the labels are
    chosen so that some rows hit top-1, some only top-5 and some neither."""
    jmodel, variables, pmodel, _ = pair
    x = np.random.RandomState(6).randn(6, 64, 64, 3).astype(np.float32)
    logits = port_apply(pmodel, x).numpy()
    order = np.argsort(-logits, -1, kind="stable")
    label = np.array([order[0, 0], order[1, 3], order[2, 8], order[3, 0], order[4, 4],
                      order[5, 0]], np.int32)
    valid = np.arange(6) < 5
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    jfn = jax_make_cls_metric_step(jmodel, mesh, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    ref = np.asarray(jfn(params, {}, jnp.asarray(x), jnp.asarray(label), jnp.asarray(valid)))
    got = make_cls_metric_step(pmodel, compute_dtype=torch.float32)(x, label, valid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, [2, 4, 5])


def jax_draws(key, h, w) -> MixupDraws:
    """The draws ``dat_segmentation_tpu/data/mixup.py`` takes from ``key``,
    by its own splits."""
    k_sel, k_lam1, k_lam2, k_box = jax.random.split(key, 4)
    ky, kx = jax.random.split(k_box)
    return MixupDraws(
        use_cutmix=bool(jax.random.bernoulli(k_sel, 0.5)),
        lam_mix=float(jax.random.beta(k_lam1, 0.8, 0.8)),
        lam_cut=float(jax.random.beta(k_lam2, 1.0, 1.0)),
        cy=int(jax.random.randint(ky, (), 0, h)),
        cx=int(jax.random.randint(kx, (), 0, w)),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixup_application_matches_jax(dtype):
    rng = np.random.RandomState(2)
    images = rng.randn(4, 24, 20, 3).astype(np.float32)
    labels = rng.randint(0, N_CLASSES, 4).astype(np.int32)
    branches = set()
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        draws = jax_draws(key, 24, 20)
        branches.add(draws.use_cutmix)
        jimg, jt = jax_mixup_cutmix(key, jnp.asarray(images).astype(dtype), jnp.asarray(labels),
                                    num_classes=N_CLASSES)
        pimg, pt = mixup_cutmix(torch.from_numpy(images).to(getattr(torch, dtype)),
                                torch.from_numpy(labels), draws, num_classes=N_CLASSES)
        assert pimg.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(pimg.float().numpy(), np.asarray(jimg.astype(jnp.float32)))
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=1e-7)
    assert branches == {True, False}


def test_mixup_sampler_draws():
    """The port's draws: targets sum to 1 (label smoothing included), a
    CutMix batch's lambda is the share of pixels kept, and a sampler set to
    a saved state draws what the original draws next."""
    images = torch.arange(2 * 16 * 12 * 3, dtype=torch.float32).reshape(2, 16, 12, 3)
    labels = torch.tensor([1, 4])
    sampler = MixupSampler(7)
    cut = 0
    for _ in range(40):
        d = sampler.draw(16, 12)
        out, t = mixup_cutmix(images, labels, d, num_classes=N_CLASSES)
        torch.testing.assert_close(t.sum(-1), torch.ones(2), rtol=0, atol=1e-6)
        assert 0.0 <= d.lam_mix <= 1.0 and 0.0 <= d.lam_cut <= 1.0
        if d.use_cutmix:
            cut += 1
            y1, y2, x1, x2 = cutmix_box(16, 12, d.lam_cut, d.cy, d.cx)
            kept = (out[0] == images[0]).all(-1).float().mean()
            assert float(kept) == pytest.approx(1 - (y2 - y1) * (x2 - x1) / (16 * 12))
            lam = float(kept)
            want = 0.9 * lam + 0.01  # on-value share of label 1, smoothing 0.1
            assert float(t[0, 1]) == pytest.approx(want, abs=1e-6)
    assert 5 < cut < 35
    state = sampler.get_state()
    a = [sampler.draw(16, 12) for _ in range(3)]
    other = MixupSampler(0)
    other.set_state(state)
    assert [other.draw(16, 12) for _ in range(3)] == a


class _Replay:
    """Stands in for the state's ``MixupSampler``: the draws of the JAX
    step ``i`` (its key folded with the step, then split for dropout and
    mixup)."""

    def __init__(self, seed):
        self.key, self.step = jax.random.PRNGKey(seed), 0

    def draw(self, h, w):
        rng = jax.random.fold_in(self.key, self.step)
        self.step += 1
        return jax_draws(jax.random.split(rng)[1], h, w)


def _train_cfg(get_config_fn):
    cfg = get_config_fn("cls_tiny_imagenet")
    return dataclasses.replace(
        cfg, model=small_classifier(get_config_fn),
        optimizer=dataclasses.replace(cfg.optimizer, lr=LR),
        schedule=dataclasses.replace(cfg.schedule, warmup_iters=0, max_iters=20),
    )


@pytest.fixture(scope="module")
def trajectories(pair):
    jmodel, variables, _, _ = pair
    rng = np.random.RandomState(0)
    batches = [{"image": rng.randn(4, 64, 64, 3).astype(np.float32),
                "label": rng.randint(0, N_CLASSES, 4).astype(np.int32)} for _ in range(STEPS)]
    jcfg = _train_cfg(jax_get_config)
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    out = {}
    for mixup, seed in ((False, 0), (True, 2)):
        torch.manual_seed(0)
        pmodel = carry(build_model(small_classifier(get_config), device="cpu"), variables)
        pstate = create_train_state(pmodel, _train_cfg(get_config))
        pstate.mixup = _Replay(seed)
        pstep = make_train_step(pmodel, task="cls", num_classes=N_CLASSES,
                                compute_dtype=torch.float32, mixup=mixup)
        port = []
        for b in batches:
            pstate, m = pstep(pstate, b)
            port.append({k: v.numpy() for k, v in m.items()})

        sched = jsched.warmup_cosine_schedule(LR, 20, warmup_iters=0,
                                              warmup_ratio=jcfg.schedule.warmup_ratio,
                                              min_lr=jcfg.schedule.min_lr)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        tx = jax_make_optimizer(sched, params, weight_decay=jcfg.optimizer.weight_decay,
                                no_decay_keys=jcfg.optimizer.no_decay_keys,
                                grad_clip=jcfg.optimizer.grad_clip)
        # placed as the step's outputs are, so that the second step does not
        # compile the step again for other input shardings
        jstate = shard_state(mesh, JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                                 opt_state=tx.init(params), batch_stats={}, tx=tx))
        jstep = jax_make_train_step(jmodel, mesh, task="cls", num_classes=N_CLASSES,
                                    compute_dtype=jnp.float32, mixup=mixup)
        ref = []
        for b in batches:
            jstate, m = jstep(jstate, shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}),
                              jax.random.PRNGKey(seed))
            ref.append({k: np.asarray(v) for k, v in m.items()})
        out[mixup] = (port, ref, [_Replay(seed).draw(64, 64) for _ in range(1)])
    return out


@pytest.mark.parametrize("mixup", [False, True], ids=["label-smoothing", "mixup-replayed"])
def test_cls_train_steps_match_jax(trajectories, mixup):
    port, ref, _ = trajectories[mixup]
    for i, (p, r) in enumerate(zip(port, ref)):
        assert set(p) == set(r) == {"loss", "grad_norm", "update_ratio", "acc1"}
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(p["grad_norm"], r["grad_norm"], rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(p["update_ratio"], r["update_ratio"], rtol=1e-3,
                                   err_msg=f"step {i}")
        assert float(p["acc1"]) == float(r["acc1"]), i
    if mixup:  # the replay reached both branches over the three steps
        branches = {_replay_branch(2, i) for i in range(STEPS)}
        assert branches == {True, False}


def _replay_branch(seed, step):
    rep = _Replay(seed)
    rep.step = step
    return rep.draw(64, 64).use_cutmix


def test_weight_stats_and_update_ratio_match_jax():
    """Per-tensor mean, population std and L2 from one device table, and
    ||update|| / ||param||, on the same arrays in both packages."""
    rng = np.random.RandomState(8)
    arrays = {"a": rng.randn(7, 5).astype(np.float32), "b": (3 + rng.randn(11)).astype(np.float32)}
    updates = {k: (1e-3 * rng.randn(*v.shape)).astype(np.float32) for k, v in arrays.items()}
    ref = jax_logging.weight_stats_on_device({k: jnp.asarray(v) for k, v in arrays.items()})
    got = port_logging.weight_stats_on_device({k: torch.from_numpy(v) for k, v in arrays.items()},
                                              prefix="")
    assert list(got) == list(ref) == ["a", "b"]
    for name in got:
        for key in ("mean", "std", "l2"):
            assert got[name][key] == pytest.approx(ref[name][key], rel=1e-5, abs=1e-7), (name, key)
    want = jax_logging.grad_update_ratio(arrays, updates)
    assert port_logging.grad_update_ratio(
        {k: torch.from_numpy(v) for k, v in arrays.items()},
        {k: torch.from_numpy(v) for k, v in updates.items()}) == pytest.approx(want, rel=1e-5)
    model_stats = port_logging.weight_stats_on_device(torch.nn.Linear(3, 2))
    assert set(model_stats) == {"weight", "bias"}
