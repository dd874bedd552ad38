"""The deformable attention's position-bias modes in the port against the
JAX package, float32 on the CPU.

The modes are the continuous bias (the DAT++ presets'), ``dwc_pe``,
``fixed_pe``, ``log_cpb``, ``no_off``, no position bias, and attention
dropout. The JAX package sends only the continuous bias without
``no_off`` or attention dropout in training to its kernel and runs the
others as its XLA composite; the port routes them the same way: K1 (K2
under grad) or the plain composite.

One module fixture computes everything on the JAX side: each mode's
``DeformableAttention`` (``kernel_impl='xla'``) forward and vjp, and three
train steps of a small UperNet with a different mode on each stage
through the JAX ``make_train_step``. Tolerances, float32 on both sides,
summed in other orders (the JAX composite samples with tap-weight
matmuls, the port with ``F.grid_sample``): a module's output to 1e-5; each
gradient g of a parameter or the input to ||dg|| <= 1e-4 ||g|| + 1e-6
||g_all|| (``proj_k.bias``'s gradient is 0 in exact arithmetic, float32
noise on both sides); the train steps as ``tests/test_torch_train.py``
holds the continuous-bias UperNet.
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
from dat_segmentation_tpu.models.deformable_attention import (
    DeformableAttention as JaxDeformableAttention,
)
from dat_segmentation_tpu.parallel import TrainState as JaxTrainState
from dat_segmentation_tpu.parallel import make_mesh
from dat_segmentation_tpu.parallel import make_train_step as jax_make_train_step
from dat_segmentation_tpu.parallel.mesh import shard_batch, shard_state
from dat_segmentation_tpu.train import make_optimizer as jax_make_optimizer
from dat_segmentation_tpu.train import schedules as jsched
from dat_segmentation_tpu.utils.torch_convert import convert_segmentor as jax_convert_segmentor
from dat_segmentation_tpu_torch import build_model, create_train_state, get_config, make_train_step
from dat_segmentation_tpu_torch.models import deformable_attention as tda
from dat_segmentation_tpu_torch.models.deformable_attention import DeformableAttention
from dat_segmentation_tpu_torch.models.layers import use_generator
from dat_segmentation_tpu_torch.serving import ServingModel, export_segmentor, save_artifact
from dat_segmentation_tpu_torch.tools.reference_schema import to_reference
from dat_segmentation_tpu_torch.train import losses as tlosses
from dat_segmentation_tpu_torch.utils import torch_convert as tc
from dat_segmentation_tpu_torch.utils.convert import convert_variables
from torch_port_helpers import carry, random_variables, small_fpn, small_upernet, with_modes

OUT_ATOL = 1e-5
GRAD_REL = 1e-4
LR, STEPS, N_CLASSES = 6e-4, 3, 8

# (mode flags, stride, ksize, offset_range_factor): the six cases of the JAX
# package's tests/test_deformable_attention.py, no position bias, and
# attention dropout in eval
CASES = {
    "continuous": dict(stride=2, ksize=5, offset_range_factor=-1.0),
    "tanh_offsets": dict(stride=1, ksize=3, offset_range_factor=2.0),
    "dwc_pe": dict(dwc_pe=True, stride=2, ksize=2, offset_range_factor=-1.0),
    "fixed_pe": dict(fixed_pe=True, stride=2, ksize=5, offset_range_factor=-1.0),
    "log_cpb": dict(log_cpb=True, stride=2, ksize=5, offset_range_factor=-1.0),
    "no_off": dict(no_off=True, stride=2, ksize=5, offset_range_factor=-1.0),
    "no_pe": dict(use_pe=False, stride=2, ksize=5, offset_range_factor=-1.0),
    "attn_drop_eval": dict(attn_drop=0.3, stride=2, ksize=5, offset_range_factor=-1.0),
}
# 8x12 queries, 4 heads in 2 groups; the tables from a config-time 6x10
# (fixed_pe's (4, 60, 15) resized to (96, 24))
GEOM = dict(dim=16, n_heads=4, n_groups=2, q_size=(6, 10))
X_SHAPE = (2, 8, 12, 16)

# a different mode on each stage of the small UperNet. fixed_pe sits where
# its table's resize to the runtime (H*W, Ns) has exact scales (stage 2 at
# 64x64: (196 - 1)/(16 - 1) and (49 - 1)/(4 - 1)): elsewhere F.interpolate,
# which the reference and the port call, takes its source rows at float32
# multiples of the scale (at stage 0, 3135/255, up to 2e-4 of a row off the
# JAX package's float64 ones), which moves the first gradient by 1.5e-4 and
# three AdamW steps far more; ``CASES`` holds an inexact resize (59/95).
MIXED = ("no_off", "dwc_pe", "fixed_pe", "log_cpb")

def _train_cfg(get_config_fn, model_cfg):
    cfg = get_config_fn("upn_tiny_160k_dp03_lr6")
    return dataclasses.replace(
        cfg, model=model_cfg, optimizer=dataclasses.replace(cfg.optimizer, lr=LR),
        schedule=dataclasses.replace(cfg.schedule, warmup_iters=0, max_iters=20))


def _batches():
    rng = np.random.RandomState(4)
    out = []
    for _ in range(STEPS):
        label = rng.randint(0, N_CLASSES, (2, 64, 64)).astype(np.int32)
        label[:, :9, :5] = 255
        out.append({"image": rng.randn(2, 64, 64, 3).astype(np.float32), "label": label})
    return out


def _module_refs():
    """Each case's JAX module: variables, input, cotangent, output and the
    vjp's gradients of the parameters and the input."""
    rng = np.random.RandomState(0)
    x = rng.randn(*X_SHAPE).astype(np.float32)
    cot = rng.randn(*X_SHAPE).astype(np.float32)
    out = {}
    for i, (name, case) in enumerate(CASES.items()):
        jmod = JaxDeformableAttention(**GEOM, **case)
        variables = random_variables(jmod, x, seed=10 + i)

        def f(params, inp, jmod=jmod):
            return jmod.apply({"params": params}, inp)

        @jax.jit
        def fwd_vjp(params, inp, c):
            y, vjp = jax.vjp(f, params, inp)
            return (y,) + vjp(c)

        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        y, gp, gx = fwd_vjp(params, jnp.asarray(x), jnp.asarray(cot))
        out[name] = dict(variables=variables, x=x, cot=cot, y=np.asarray(y),
                         grads=convert_variables({"params": jax.device_get(gp)}),
                         gx=np.asarray(gx))
    return out


def _jax_trajectory(variables, batches):
    jcfg = _train_cfg(jax_get_config, with_modes(small_upernet(jax_get_config), MIXED))
    jmodel = jax_build_model(jcfg.model)
    sched = jsched.warmup_poly_schedule(LR, 20, warmup_iters=0, warmup_ratio=1e-6, power=1.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(sched, params, weight_decay=0.01,
                            no_decay_keys=JaxOptimizerConfig().no_decay_keys)
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    # placed as the step's outputs are: the second step does not compile again
    state = shard_state(mesh, JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), tx=tx))
    step = jax_make_train_step(jmodel, mesh, aux_weight=0.4, num_classes=N_CLASSES,
                               compute_dtype=jnp.float32)
    metrics = []
    for b in batches:
        state, m = step(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}),
                        jax.random.PRNGKey(0))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    final = {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}
    return metrics, convert_variables(final)


@pytest.fixture(scope="module")
def ref():
    """The JAX side of every comparison of this file."""
    batches = _batches()
    jmodel = jax_build_model(with_modes(small_upernet(jax_get_config), MIXED))
    variables = random_variables(jmodel, batches[0]["image"], seed=5, train=False)
    metrics, final = _jax_trajectory(variables, batches)
    return dict(modules=_module_refs(), batches=batches, variables=variables,
                metrics=metrics, final=final)


# ------------------------------------------------------------- the module --


def _port_module(r, case):
    return carry(DeformableAttention(**GEOM, **case), r["variables"])


@pytest.mark.parametrize("name", list(CASES))
def test_attention_mode_matches_jax(ref, name):
    """Forward and the gradient of every parameter and of the input, under
    one cotangent, against the JAX module's vjp. A parameter the output
    does not reach (no_off's offset net) has a zero JAX gradient and no
    port gradient."""
    r = ref["modules"][name]
    port = _port_module(r, CASES[name])
    x = torch.from_numpy(r["x"]).requires_grad_(True)
    y = port(x)
    np.testing.assert_allclose(y.detach().numpy(), r["y"], rtol=0, atol=OUT_ATOL)
    y.backward(torch.from_numpy(r["cot"]))
    grads = dict(port.named_parameters())
    assert set(grads) == set(r["grads"])
    wants = dict(r["grads"], x=torch.from_numpy(r["gx"]))
    total = sum(float(w.norm()) ** 2 for w in wants.values()) ** 0.5
    for pname, want in sorted(wants.items()):
        got = x.grad if pname == "x" else grads[pname].grad
        got = torch.zeros_like(want) if got is None else got
        err = float((got - want).norm())
        assert err <= GRAD_REL * float(want.norm()) + 1e-6 * total, (pname, err)
    if name == "no_off":
        assert all(grads[n].grad is None for n in grads if n.startswith("offset_"))
        assert all(r["grads"][n].abs().max() == 0 for n in r["grads"] if n.startswith("offset_"))


def test_attention_dropout_draws_from_the_callers_generator(ref):
    """In training, attention dropout (its mask over (B, heads, H*W, Ns))
    runs in the composite, not the kernel, and draws from the generator
    the caller hands it: the same seed gives the same output, another
    seed another one, the global RNG does not move; in eval it is the JAX
    module's deterministic output (the ``attn_drop_eval`` case)."""
    r = ref["modules"]["attn_drop_eval"]
    port = _port_module(r, CASES["attn_drop_eval"]).train()
    assert not port.runs_kernel() and port.eval().runs_kernel()
    port.train()
    x = torch.from_numpy(r["x"])
    rng = torch.get_rng_state()

    def draw(seed):
        use_generator(port, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return port(x)

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(rng, torch.get_rng_state())
    assert np.abs(a.numpy() - r["y"]).max() > 10 * OUT_ATOL  # a mask was applied
    port.eval()
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(), r["y"], rtol=0, atol=OUT_ATOL)


def test_no_off_needs_sides_that_are_stride_multiples():
    port = DeformableAttention(**GEOM, **CASES["no_off"])
    with pytest.raises(ValueError, match=r"multiples of 2, got 8x11"):
        port(torch.zeros(1, 8, 11, 16))


# ----------------------------------------------------- the whole model --


def _first_grad_norms(variables, batch):
    """||g|| of every parameter at the first step in float64 (rounding
    taken out), None where the loss does not reach the parameter."""
    model = carry(build_model(with_modes(small_upernet(get_config), MIXED), device="cpu"),
                  variables)
    model.double().train()
    logits, aux = model(torch.from_numpy(batch["image"]).double())
    loss = tlosses.segmentation_loss(logits, aux, torch.from_numpy(batch["label"]).long(),
                                     aux_weight=0.4)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: None if g is None else float(g.norm()) for n, g in zip(names, grads)}


def test_mixed_model_three_train_steps_match_jax(ref):
    """The small UperNet with no_off, dwc_pe, fixed_pe and log_cpb on its
    four stages (no K1 block) takes three steps through the port's
    ``make_train_step`` and the JAX one from the same weights: loss
    (rtol 1e-5), grad norm (1e-4), update ratio (1e-3) and the IoU counts
    of every step; then every parameter leaf to 1e-4 of its norm and the
    BN statistics to 1e-4, but the leaves whose gradient is float32 noise
    (0 in exact arithmetic: each block's ``proj_k.bias`` and the
    ``out_norm`` biases the heads' BatchNorms centre), whose elements step
    either way under AdamW. The no_off stage's offset net, which the loss
    does not reach, takes the JAX zero gradient: AdamW decays it alike."""
    cfg = with_modes(small_upernet(get_config), MIXED)
    torch.manual_seed(0)
    model = carry(build_model(cfg, device="cpu"), ref["variables"])
    assert not any(m.runs_kernel() for m in model.modules() if isinstance(m, DeformableAttention))
    state = create_train_state(model, _train_cfg(get_config, cfg))
    step = make_train_step(model, num_classes=N_CLASSES, compute_dtype=torch.float32)
    for i, (b, want) in enumerate(zip(ref["batches"], ref["metrics"])):
        _, m = step(state, b)
        np.testing.assert_allclose(m["loss"].numpy(), want["loss"], rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(m["grad_norm"].numpy(), want["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(m["update_ratio"].numpy(), want["update_ratio"], rtol=1e-3)
        np.testing.assert_array_equal(m["inter"].numpy(), want["inter"])
        np.testing.assert_array_equal(m["union"].numpy(), want["union"])
    norms = _first_grad_norms(ref["variables"], ref["batches"][0])
    total = sum(g * g for g in norms.values() if g is not None) ** 0.5
    unused = {n for n, g in norms.items() if g is None}
    assert unused == {f"backbone.stage_0.attn_0.{p}" for p in (
        "offset_dwc.weight", "offset_dwc.bias", "offset_ln.weight", "offset_ln.bias",
        "offset_proj.weight")}
    noise = {n for n, g in norms.items() if g is not None and g <= 1e-6 * total}
    assert noise == {"backbone.stage_0.attn_0.proj_k.bias", "backbone.stage_1.attn_1.proj_k.bias",
                     "backbone.stage_2.attn_0.proj_k.bias", "backbone.stage_3.attn_0.proj_k.bias",
                     "backbone.out_norm_0.bias", "backbone.out_norm_1.bias"}
    got = model.state_dict()
    assert set(got) == set(ref["final"])
    for name, w in ref["final"].items():
        if name.endswith("num_batches_tracked") or name in noise:
            continue
        g, w = got[name].numpy(), w.numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), name


ROUTE_MODES = ("dwc_pe", "continuous", "no_pe", "continuous")


def _jax_gate(cfg_bb, stage, training, attn_drop):
    """The JAX package's predicate (``deformable_attention.py:243-252``
    there, its kernel asked for and no exact padding) for a stage."""
    return (cfg_bb.use_pes[stage]
            and not (cfg_bb.dwc_pes[stage] or cfg_bb.fixed_pes[stage] or cfg_bb.log_cpb[stage])
            and not cfg_bb.no_offs[stage] and (attn_drop == 0.0 or not training))


@pytest.mark.parametrize("attn_drop,training", [(0.0, False), (0.0, True), (0.2, False),
                                                (0.2, True)])
def test_k1_route_follows_the_jax_gate(monkeypatch, attn_drop, training):
    """Block by block, ``deform_attn`` (K1, and K2 under grad, on the card)
    runs exactly where the JAX predicate holds; the other blocks run the
    composite. The small FPN with dwc_pe, the continuous bias, no bias and
    the continuous bias on its stages (four 'D' blocks), in eval and in
    training, with and without attention dropout."""
    cfg = with_modes(small_fpn(get_config), ROUTE_MODES)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                attn_drop_rate=attn_drop))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu").train(training)
    use_generator(model, torch.Generator().manual_seed(0))
    calls = []
    real = tda.deform_attn
    monkeypatch.setattr(tda, "deform_attn", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    blocks = [(i, m) for i in range(4) for n, m in getattr(model.backbone, f"stage_{i}").named_modules()
              if isinstance(m, DeformableAttention)]
    want = [_jax_gate(cfg.backbone, i, training, attn_drop) for i, _ in blocks]
    assert [m.runs_kernel() for _, m in blocks] == want
    with torch.no_grad():
        model(torch.from_numpy(np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)))
    assert len(blocks) == 4 and len(calls) == sum(want)
    assert sum(want) == (0 if training and attn_drop else 2)


# ------------------------------------------------- checkpoints and export --

CONVERT_MODES = {"mixed": MIXED, "others": ("continuous", "no_pe", "dwc_pe", "log_cpb")}


@pytest.mark.parametrize("modes", list(CONVERT_MODES))
@pytest.mark.parametrize("mmseg", [True, False], ids=["mmseg", "standalone"])
def test_reference_checkpoint_carries_every_mode(modes, mmseg):
    """The reference's ``.pth`` keys for each mode (``attns.{d}.rpe_table``:
    dwc_pe's conv, log_cpb's ``.0``/``.2`` Linears, the fixed_pe or
    continuous table) by the inverse of the port's table, read back by the
    port's ``convert_segmentor`` and by the JAX converter followed by
    ``convert_variables``: both give the model's tensors exactly."""
    cfg = with_modes(small_upernet(get_config), CONVERT_MODES[modes])
    torch.manual_seed(0)
    want = build_model(cfg, device="cpu").state_dict()
    sd = to_reference(want, cfg, mmseg=mmseg)
    pe_keys = {k for k in sd if ".rpe_table" in k}
    assert pe_keys, sorted(sd)[:5]
    for got in (tc.convert_segmentor(sd, cfg),
                convert_variables(jax_convert_segmentor(
                    {k: v.numpy() for k, v in sd.items()},
                    with_modes(small_upernet(jax_get_config), CONVERT_MODES[modes])))):
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_mixed_model_exports_and_equals_the_live_model(tmp_path):
    """A model with the composite (dwc_pe, stages 0-1) and K1's blocks
    (the continuous bias, stages 2-3) exports on the CPU: the K1 blocks as
    the ``dat::deform_attn_fwd`` op (2), the composite as ATen ops; the
    artifact, served by ``ServingModel``, equals the live model."""
    cfg = with_modes(small_fpn(get_config), ("dwc_pe", "dwc_pe", "continuous", "continuous"))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    program = export_segmentor(cfg, model.state_dict(), batch=1, input_size=(64, 64),
                               compute_dtype=torch.float32, device="cpu")
    calls = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert calls.count("dat.deform_attn_fwd.default") == 2
    srv = ServingModel.load(save_artifact(tmp_path, {"seg": program}, model_cfg=cfg,
                                          num_classes=cfg.num_classes))
    assert srv.entries["seg"]["kernels"] == ["dat::deform_attn_fwd"]
    x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        live = model(torch.from_numpy(x), upsample=False)
    assert torch.equal(srv("seg", x), live)
