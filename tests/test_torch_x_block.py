"""The port's fused X block (K3's plain version, its autograd Function and
the backbone's gate) against the JAX package, on the CPU.

The JAX side runs ``fused_x_block`` in Pallas interpret mode, as
``tests/test_x_block.py`` does, and its ``_composite``. Parameters are
drawn in the JAX layouts (HWIO depthwise kernels, (in, out) dense kernels)
from numpy seeds and carried into the port's layouts ((C, 1, k, k) and
(out, in)). Float32 on both sides, summed in other orders: forward rtol
2e-4, atol 2e-5; gradients rtol 1e-3, atol 1e-4; a train step's loss rtol
1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.models.dat import DAT as JaxDAT
from dat_segmentation_tpu.ops.pallas import x_block as jxb
from dat_segmentation_tpu_torch import build_model, create_train_state, get_config, make_train_step
from dat_segmentation_tpu_torch.models.dat import DAT
from dat_segmentation_tpu_torch.ops import x_block as txb
from torch_port_helpers import carry, jax_apply, random_variables, small_upernet

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
NAMES = ("w3", "b3", "w7", "b7", "g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")


def _jax_params(C, k, lpu, seed=0, E=4):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=0.2):
        return (rng.randn(*shape) * scale).astype(np.float32)

    H4 = C * E
    return dict(
        w3=t(3, 3, 1, C) if lpu else None, b3=t(C) if lpu else None,
        w7=t(k, k, 1, C), b7=t(C), g=t(C, scale=1.0) + 1.0, be=t(C),
        wf1=t(C, H4), bf1=t(H4), wd=t(3, 3, 1, H4), bd=t(H4), wf2=t(H4, C), bf2=t(C),
    )


def _port_params(p):
    """JAX layouts -> the port's: HWIO depthwise -> (C, 1, k, k), (in, out) -> (out, in)."""
    out = {}
    for name, a in p.items():
        if a is None:
            out[name] = None
        elif a.ndim == 4:
            out[name] = torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
        elif a.ndim == 2:
            out[name] = torch.from_numpy(np.ascontiguousarray(a.T))
        else:
            out[name] = torch.from_numpy(a.copy())
    return out


def _jax_args(p):
    return [None if p[n] is None else jnp.asarray(p[n]) for n in NAMES]


SHAPES = [
    dict(B=2, H=16, W=16, C=16, k=7),
    dict(B=1, H=8, W=24, C=8, k=7),   # rectangular
    dict(B=1, H=16, W=8, C=16, k=3),  # small window
    dict(B=1, H=8, W=8, C=8, k=5),
]


@pytest.mark.parametrize("lpu", [True, False], ids=["lpu", "no_lpu"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "{B}x{H}x{W}x{C}_k{k}".format(**s))
def test_reference_matches_jax_composite_and_kernel(shape, lpu):
    B, H, W, C, k = (shape[s] for s in "BHWCk")
    x = (np.random.RandomState(1).randn(B, H, W, C) * 0.5).astype(np.float32)
    p = _jax_params(C, k, lpu)
    ref = jxb._composite(jnp.asarray(x), *_jax_args(p), k=k, with_lpu=lpu)
    kern = jax.jit(lambda xx, *a: jxb.fused_x_block(xx, *a, k, lpu, True))(
        jnp.asarray(x), *_jax_args(p))
    pp = _port_params(p)
    got = txb.x_block_reference(torch.from_numpy(x), *[pp[n] for n in NAMES], with_lpu=lpu)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **FWD)
    # the public entry, through the autograd Function, on the CPU
    via_fn = txb.fused_x_block(torch.from_numpy(x), *[pp[n] for n in NAMES], k, lpu)
    np.testing.assert_allclose(via_fn.numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=["square", "rectangular"])
def test_conv_mlp_matches_jax(shape):
    B, H, W, C = (shape[s] for s in "BHWC")
    x = (np.random.RandomState(2).randn(B, H, W, C) * 0.5).astype(np.float32)
    p = _jax_params(C, 1, False, seed=4)
    args = [jnp.asarray(p[n]) for n in ("g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")]
    ref = jax.jit(lambda xx, *a: jxb.fused_conv_mlp(xx, *a, interpret=True))(jnp.asarray(x), *args)
    pp = _port_params(p)
    got = txb.fused_conv_mlp(torch.from_numpy(x), *[pp[n] for n in
                                                    ("g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("mode", ["lpu", "no_lpu", "mlp"])
def test_function_gradients_match_jax(mode):
    """Gradients of x and of every parameter present, through the port's
    XBlockFunction (backward: autograd of the plain version) and through
    the JAX custom_vjp of ``fused_x_block``; absent parameters get None."""
    B, H, W, C, k = 1, 8, 16, 8, 7
    lpu = mode == "lpu"
    rng = np.random.RandomState(3)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    cot = rng.randn(B, H, W, C).astype(np.float32)
    p = _jax_params(C, k, lpu, seed=5)
    if mode == "mlp":
        p.update(w7=None, b7=None)
    present = [n for n in NAMES if p[n] is not None]

    def loss(xj, *leaves):
        kw = dict(zip(present, leaves))
        if mode == "mlp":
            out = jxb.fused_conv_mlp(xj, *(kw[n] for n in ("g", "be", "wf1", "bf1", "wd", "bd",
                                                           "wf2", "bf2")), interpret=True)
        else:
            out = jxb.fused_x_block(xj, *(kw.get(n) for n in NAMES), k, lpu, True)
        return jnp.sum(out * cot)

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(len(present) + 1))))(
        jnp.asarray(x), *(jnp.asarray(p[n]) for n in present))

    pp = {n: (None if t is None else t.requires_grad_(True)) for n, t in _port_params(p).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    if mode == "mlp":
        out = txb.fused_conv_mlp(xt, *(pp[n] for n in ("g", "be", "wf1", "bf1", "wd", "bd",
                                                        "wf2", "bf2")))
    else:
        out = txb.fused_x_block(xt, *(pp[n] for n in NAMES), k, lpu)
    (out * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrads[0]), **GRAD, err_msg="x")
    back = _port_params({n: np.asarray(g) for n, g in zip(present, jgrads[1:])})
    for n in NAMES:
        if p[n] is None:
            assert pp[n] is None
            continue
        np.testing.assert_allclose(pp[n].grad.numpy(), back[n].numpy(), **GRAD, err_msg=n)


# The geometry of tests/test_x_block.py:test_stage_fused_matches_unfused, at
# 64x64 (stages 16, 8, 4, 2: K3 runs at stages 0 and 1, the gate refuses 2
# and 3), and a stage spec with 'D' blocks where K3 runs, for MLP-only mode.
# Widths of 32, the kernel's channel multiple, where K3 runs.
DAT_KW = dict(
    img_size=32, patch_size=4, dim_stem=8, dims=(32, 32, 32, 64),
    depths=(2, 1, 1, 1), heads=(2, 2, 4, 4), groups=(1, 2, 2, 4),
    stage_spec=(("X", "X"), ("X",), ("X",), ("D",)),
    use_pes=(True,) * 4, strides=(8, 4, 2, 1),
    offset_range_factor=(-1, -1, -1, -1), use_dwc_mlps=(True,) * 4,
    use_lpus=(True, True, False, True), use_conv_patches=True,
)
SPECS = {
    "x_test_geometry": DAT_KW["stage_spec"],
    "d_blocks_fused": (("X", "D"), ("D",), ("X",), ("D",)),
}


@pytest.fixture(scope="module", params=list(SPECS))
def dat_pair(request):
    kw = dict(DAT_KW, stage_spec=SPECS[request.param])
    x = np.random.RandomState(5).randn(1, 64, 64, 3).astype(np.float32)
    jfused = JaxDAT(**kw, kernel_impl="pallas")
    variables = random_variables(jfused, x, seed=6)
    ref = [np.asarray(a) for a in jax_apply(jfused, variables, x)]
    port = {impl: carry(DAT(**kw, kernel_impl=impl), variables) for impl in ("pallas", "auto")}
    return x, ref, port


def test_dat_pallas_matches_jax_pallas(dat_pair):
    x, ref, port = dat_pair
    with torch.no_grad():
        got = port["pallas"](torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, **FWD)


def test_dat_fused_matches_unfused(dat_pair):
    x, _, port = dat_pair
    with torch.no_grad():
        fused = port["pallas"](torch.from_numpy(x))
        plain = port["auto"](torch.from_numpy(x))
    for a, b in zip(fused, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD)


def test_gate_per_stage(dat_pair, monkeypatch):
    """K3 runs once per block at the stages whose true H, W are multiples
    of 8, and only with kernel_impl='pallas'; a fused 'X' block does not
    also run its separate LPU."""
    x, _, port = dat_pair
    sizes = [16, 8, 4, 2]  # the stages' sides at 64x64
    calls, lpu_calls, hooks = [], [], []
    real = txb.x_block_fwd

    def spy(xx, *a, **kw):
        calls.append(tuple(xx.shape))
        return real(xx, *a, **kw)

    monkeypatch.setattr(txb, "x_block_fwd", spy)
    model = port["pallas"]
    stages = [getattr(model, f"stage_{i}") for i in range(4)]
    for i, stage in enumerate(stages):
        for d in range(stage.depths):
            if stage.use_lpu:
                hooks.append(stage._block("lpu", d).register_forward_hook(
                    lambda m, a, o, i=i, d=d: lpu_calls.append((i, d))))
    try:
        with torch.no_grad():
            model(torch.from_numpy(x))
            n_pallas = len(calls)
            port["auto"](torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    expected = sum(len(s.stage_spec) for s, side in zip(stages, sizes) if side % 8 == 0)
    assert n_pallas == expected and len(calls) == expected  # 'auto' adds none
    assert all(c[1] % 8 == 0 and c[2] % 8 == 0 for c in calls)
    # separate LPUs ran only in 'D' blocks and in stages the gate refused
    assert lpu_calls
    for i, d in lpu_calls:
        assert stages[i].stage_spec[d] == "D" or sizes[i] % 8, (i, d)
    for i, stage in enumerate(stages):
        assert stage.fuses(16, 24) and not stage.fuses(12, 16)
        assert not getattr(port["auto"], f"stage_{i}").fuses(16, 16)


def _stage(dim, expansion=4, window=7, spec=("X",)):
    from dat_segmentation_tpu_torch.models.dat import TransformerStage

    return TransformerStage(
        in_dim=dim, fmap_size=(2, 2), window_size=window, dim_embed=dim, depths=len(spec),
        stage_spec=spec, n_groups=1, use_pe=True, heads=2, stride=1, offset_range_factor=-1,
        dwc_pe=False, no_off=False, fixed_pe=False, attn_drop=0.0, proj_drop=0.0,
        expansion=expansion, drop=0.0, drop_path_rates=[0.0] * len(spec), use_dwc_mlp=True,
        ksize=3, layer_scale_value=-1, use_lpu=True, use_cmt_mlp=False, log_cpb=False,
        kernel_impl="pallas",
    )


@pytest.mark.parametrize("kw,fuses", [
    (dict(dim=txb.CHANNEL_MULTIPLE), True),
    (dict(dim=txb.CHANNEL_MULTIPLE + 16), False),  # not a multiple of the channel chunk
    (dict(dim=txb.CHANNEL_MULTIPLE // 2), False),
    (dict(dim=txb.MAX_CHANNELS), True),
    (dict(dim=txb.MAX_CHANNELS + txb.CHANNEL_MULTIPLE), False),
    (dict(dim=32, expansion=2), True),  # hidden width 64
    (dict(dim=32, expansion=3), False),  # hidden width 96
    (dict(dim=32, window=max(txb.WINDOWS)), True),
    (dict(dim=32, window=max(txb.WINDOWS) + 2), False),
    (dict(dim=32, window=1), True),
    (dict(dim=32, window=max(txb.WINDOWS) + 2, spec=("D",)), True),  # MLP mode takes no window
], ids=["c32", "c48", "c16", "c1024", "c1056", "e64", "e96", "k9", "k11", "k1", "k11_d_only"])
def test_gate_keeps_to_the_kernel_limits(kw, fuses):
    """The gate refuses a stage the CUDA launch would refuse (x_block._check):
    C off the channel multiple or above MAX_CHANNELS, a hidden width off
    HIDDEN_MULTIPLE, an 'X' block's window outside WINDOWS; each at its
    limit and one past it."""
    stage = _stage(**kw).eval()
    assert stage.fuses(16, 16) == fuses


def test_pallas_backbone_with_window_11_runs_unfused_where_refused(monkeypatch):
    """A 'pallas' backbone with a window of 11 (outside the kernel's
    windows) builds and runs: stages with 'X' blocks run the unfused chain,
    the 'D'-only stage at side 8 still runs K3 in MLP mode, and the output
    equals the 'auto' backbone's on the same weights."""
    kw = dict(DAT_KW, stage_spec=SPECS["d_blocks_fused"], window_sizes=(11,) * 4)
    pallas = DAT(**kw, kernel_impl="pallas").eval()
    auto = DAT(**kw, kernel_impl="auto").eval()
    auto.load_state_dict(pallas.state_dict())
    calls = []
    real = txb.x_block_fwd

    def spy(xx, *a, **k):
        calls.append(tuple(xx.shape))
        return real(xx, *a, **k)

    monkeypatch.setattr(txb, "x_block_fwd", spy)
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        got, ref = pallas(x), auto(x)
    assert calls == [(1, 8, 8, 32)]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD)


def test_gate_refuses_dropout_in_training():
    kw = dict(DAT_KW, drop_rate=0.1)
    model = DAT(**kw, kernel_impl="pallas").eval()
    stage = model.stage_0
    assert stage.fuses(8, 8)
    model.train()
    assert not stage.fuses(8, 8)
    model.eval()
    cmt = DAT(**dict(DAT_KW, use_cmt_mlps=(True,) * 4), kernel_impl="pallas")
    assert not cmt.stage_0.fuses(8, 8)


def test_small_upernet_train_step_pallas_matches_jax():
    """One float32 train step of the small UperNet (64x64: K3 runs at
    stages 0 and 1) with kernel_impl='pallas' on both sides, from the same
    weights and batch, drop path and dropout 0: the loss to rtol 1e-5, the
    gradient norm to rtol 1e-4, the IoU counts equal."""
    from dat_segmentation_tpu.configs.schema import OptimizerConfig as JaxOptimizerConfig
    from dat_segmentation_tpu.parallel import TrainState as JaxTrainState
    from dat_segmentation_tpu.parallel import make_mesh
    from dat_segmentation_tpu.parallel import make_train_step as jax_make_train_step
    from dat_segmentation_tpu.parallel.mesh import shard_batch
    from dat_segmentation_tpu.train import make_optimizer as jax_make_optimizer
    from dat_segmentation_tpu.train import schedules as jsched

    def pallas(get_config_fn):
        cfg = small_upernet(get_config_fn)
        return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                     kernel_impl="pallas"))

    rng = np.random.RandomState(7)
    label = rng.randint(0, 8, (2, 64, 64)).astype(np.int32)
    label[:, :9, :5] = 255
    batch = {"image": rng.randn(2, 64, 64, 3).astype(np.float32), "label": label}

    jmodel = jax_build_model(pallas(jax_get_config))
    variables = random_variables(jmodel, batch["image"], seed=8, train=False)
    sched = jsched.warmup_poly_schedule(6e-4, 20, warmup_iters=0, warmup_ratio=1e-6, power=1.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(sched, params, weight_decay=0.01,
                            no_decay_keys=JaxOptimizerConfig().no_decay_keys)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                           tx=tx)
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    jstep = jax_make_train_step(jmodel, mesh, aux_weight=0.4, num_classes=8,
                                compute_dtype=jnp.float32)
    _, ref = jstep(jstate, shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
                   jax.random.PRNGKey(0))

    model_cfg = pallas(get_config)
    cfg = get_config("upn_tiny_160k_dp03_lr6")
    cfg = dataclasses.replace(
        cfg, model=model_cfg, optimizer=dataclasses.replace(cfg.optimizer, lr=6e-4),
        schedule=dataclasses.replace(cfg.schedule, warmup_iters=0, max_iters=20))
    torch.manual_seed(0)
    model = carry(build_model(model_cfg, device="cpu"), variables)
    assert model.backbone.stage_0.fusable and model.backbone.stage_1.fusable
    state = create_train_state(model, cfg)
    _, got = make_train_step(model, num_classes=8, compute_dtype=torch.float32)(state, batch)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(ref["grad_norm"]), rtol=1e-4)
    np.testing.assert_array_equal(got["inter"].numpy(), np.asarray(ref["inter"]))
    np.testing.assert_array_equal(got["union"].numpy(), np.asarray(ref["union"]))
