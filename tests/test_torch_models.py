"""The PyTorch port's models against the JAX package, float32 on the CPU.

Each layer module, DeformableAttention, the DAT backbone, the heads and
the small SemanticFPN and UperNet EncoderDecoders run in both packages on
the same numpy input,
with the JAX variables (drawn from a numpy seed, no scale 1 and no bias 0)
carried into the port by ``utils/convert.py``. Tolerances: 1e-5 for one
layer and 1e-4 for the whole segmentor's logits -- float32 on both sides,
with convolutions, matmuls and the softmax summed in another order, and
the JAX attention's tap-weight matmuls against the port's gathers.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as tnn
from flax import linen as fnn

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.configs import list_configs as jax_list_configs
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.models import heads as jh
from dat_segmentation_tpu.models import layers as jl
from dat_segmentation_tpu.models.builder import build_backbone as jax_build_backbone
from dat_segmentation_tpu.models.deformable_attention import (
    DeformableAttention as JaxDeformableAttention,
)
from dat_segmentation_tpu_torch.configs import get_config, list_configs
from dat_segmentation_tpu_torch.models import build_model
from dat_segmentation_tpu_torch.models import layers as tl
from dat_segmentation_tpu_torch.models.deformable_attention import DeformableAttention
from dat_segmentation_tpu_torch.models import heads as th
from dat_segmentation_tpu_torch.utils.convert import convert_variables
from torch_port_helpers import (
    carry,
    jax_apply,
    port_apply,
    random_variables,
    small_fpn,
    small_upernet,
)

LAYER_ATOL = 1e-5
MODEL_ATOL = 1e-4


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- presets --


def test_port_lists_the_same_presets():
    assert list_configs() == jax_list_configs()


@pytest.mark.parametrize("name", jax_list_configs())
def test_preset_equals_jax_preset_field_by_field(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))


# ----------------------------------------------------------------- layers --


class _JaxConv(fnn.Module):
    features: int
    kernel: int
    stride: int = 1
    padding: int = 0
    groups: int = 1
    use_bias: bool = True

    @fnn.compact
    def __call__(self, x):
        return jl.conv2d(x, self.features, self.kernel, stride=self.stride,
                         padding=self.padding, groups=self.groups,
                         use_bias=self.use_bias, name="conv")


class _JaxDense(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jl.dense(x, 6, name="dense")


class _JaxLN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jl.LayerNorm2d(name="ln")(x)


class _JaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jl.batch_norm(x, use_running_average=True, name="bn")


class _JaxBNTrain(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jl.batch_norm(x, use_running_average=False, name="bn")


class _JaxWrap(fnn.Module):
    """A JAX layer as the child ``inner`` of a module."""

    inner: fnn.Module

    @fnn.compact
    def __call__(self, x):
        return self.inner(x)


class _Call(tnn.Module):
    """A port layer as the child ``name`` of a module, as in the JAX tree."""

    def __init__(self, name, child):
        super().__init__()
        self.add_module(name, child)
        self._name = name

    def forward(self, x):
        return getattr(self, self._name)(x)


_C = 8
_LAYERS = {
    "conv3": (_JaxConv(8, 3, padding=1), lambda: tl.Conv2d(_C, 8, 3, padding=1), "conv"),
    "conv3_s2": (_JaxConv(8, 3, stride=2, padding=1),
                 lambda: tl.Conv2d(_C, 8, 3, stride=2, padding=1), "conv"),
    "conv2_s2_nobias": (_JaxConv(16, 2, stride=2, use_bias=False),
                        lambda: tl.Conv2d(_C, 16, 2, stride=2, bias=False), "conv"),
    "conv1x1": (_JaxConv(16, 1), lambda: tl.Conv2d(_C, 16, 1), "conv"),
    "dwconv7": (_JaxConv(_C, 7, padding=3, groups=_C),
                lambda: tl.Conv2d(_C, _C, 7, padding=3, groups=_C), "conv"),
    "dwconv9_s8": (_JaxConv(_C, 9, stride=8, padding=4, groups=_C),
                   lambda: tl.Conv2d(_C, _C, 9, stride=8, padding=4, groups=_C), "conv"),
    "dense": (_JaxDense(), lambda: tnn.Linear(_C, 6), "dense"),
    "layernorm": (_JaxLN(), lambda: tl.LayerNorm2d(_C), "ln"),
    "batchnorm_eval": (_JaxBN(), lambda: tl.BatchNorm2d(_C), "bn"),
    "mlp": (_JaxWrap(jl.Mlp(4)), lambda: tl.Mlp(_C, 4), "inner"),
    "conv_mlp": (_JaxWrap(jl.ConvMlp(4)), lambda: tl.ConvMlp(_C, 4), "inner"),
    "cmt_conv_mlp": (_JaxWrap(jl.CmtConvMlp(4)), lambda: tl.CmtConvMlp(_C, 4), "inner"),
    "layerscale": (_JaxWrap(jl.LayerScale(0.3)), lambda: tl.LayerScale(_C, 0.3), "inner"),
    "droppath_eval": (_JaxWrap(jl.DropPath(0.5, deterministic=True)),
                      lambda: tl.DropPath(0.5), "inner"),
}


@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_layer_matches_jax(name):
    jmod, make_port, child = _LAYERS[name]
    x = _x((2, 16, 24, _C), seed=5)
    variables = random_variables(jmod, x, seed=1)
    ref = jax_apply(jmod, variables, x)
    port = carry(_Call(child, make_port()), variables)
    got = port_apply(port, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LAYER_ATOL)


def test_droppath_in_training_drops_whole_samples():
    """timm semantics: each sample is zeroed or scaled by 1/keep as a whole,
    the mask drawn from the generator the caller hands it."""
    dp = tl.DropPath(0.5).train()
    tl.use_generator(dp, torch.Generator().manual_seed(0))
    y = dp(torch.ones(64, 3, 4, 5))
    per_sample = y.reshape(64, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert torch.all(per_sample.min(1).values == per_sample.max(1).values)
    assert 0 < (per_sample[:, 0] == 0).sum() < 64


def test_dropout_is_elementwise_and_seeded():
    """The heads' dropout is flax's elementwise one (not Dropout2d): masks
    differ within a sample's channels; the same seed gives the same mask,
    another seed another one."""
    def draw(seed):
        d = tl.Dropout(0.5).train()
        tl.use_generator(d, torch.Generator().manual_seed(seed))
        return d(torch.ones(2, 4, 4, 32))

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert (a[0, 0, 0] == 0).any() and (a[0, 0, 0] != 0).any()


def test_drop_path_masks_follow_the_seed():
    x = torch.ones(256, 2, 2, 3)

    def mask(seed):
        dp = tl.DropPath(0.3).train()
        tl.use_generator(dp, torch.Generator().manual_seed(seed))
        return dp(x)[:, 0, 0, 0]

    assert torch.equal(mask(5), mask(5)) and not torch.equal(mask(5), mask(6))


def test_dropout_in_training_needs_a_generator():
    """Training never falls back to the global RNG."""
    with pytest.raises(RuntimeError, match="torch.Generator"):
        tl.DropPath(0.1).train()(torch.ones(2, 3))
    assert torch.equal(tl.DropPath(0.0).train()(torch.ones(2, 3)), torch.ones(2, 3))


@pytest.mark.parametrize(
    "shape,dtype",
    [((2, 16, 24, _C), np.float32), ((2, 1, 1, _C), np.float32), ((4, 3, 5, _C), "bfloat16")],
    ids=["map", "ppm_scale1_batch2", "bf16"],
)
def test_batchnorm_train_matches_flax(shape, dtype):
    """Training mode: the output from the biased batch statistics, and the
    running statistics after one call equal flax's batch_stats to 1e-6
    (biased variance; the PPM's (B, 1, 1, C) map at B = 2 is where
    PyTorch's unbiased update would differ 2x). The output to 1e-5, but
    5e-5 over two values a channel, where flax's E[x²] - E[x]² loses
    digits that F.batch_norm keeps; bf16 inputs: statistics in float32 on
    both sides, output to bf16 rounding."""
    import jax.numpy as jnp

    x = _x(shape, seed=8)
    jmod = _JaxBNTrain()
    variables = random_variables(jmod, x, seed=4)
    xj = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else x
    ref, upd = jax_apply(jmod, variables, xj, mutable=["batch_stats"])
    port = carry(_Call("bn", tl.BatchNorm2d(_C)), variables).train()
    xt = torch.from_numpy(x).to(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(x)
    with torch.no_grad():
        got = port(xt)
    atol = 2e-2 if dtype == "bfloat16" else 5e-5 if shape[0] * shape[1] * shape[2] == 2 else LAYER_ATOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=atol)
    stats = upd["batch_stats"]["bn"]
    np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(stats["var"]), rtol=0, atol=1e-6)


def test_gelu_is_exact_erf():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(
        tl.gelu(torch.from_numpy(x)).numpy(), np.asarray(jl.gelu(x)), rtol=0, atol=1e-6
    )


# ----------------------------------------------------- deformable attention --


@pytest.mark.parametrize("impl", ["xla", "gather"])
@pytest.mark.parametrize("orf", [-1.0, 2.0])
def test_deformable_attention_matches_jax(orf, impl):
    """Both JAX forms (tap-weight matmuls and gathers), raw clipped offsets
    (orf < 0, DAT++) and tanh-scaled ones (orf >= 0, pos may leave [-1, 1])."""
    kw = dict(dim=32, n_heads=2, n_groups=2, stride=2, ksize=3, q_size=(8, 8),
              offset_range_factor=orf)
    jmod = JaxDeformableAttention(**kw, kernel_impl=impl)
    x = _x((2, 8, 12, 32), seed=6)
    variables = random_variables(jmod, x, seed=2)
    ref = jax_apply(jmod, variables, x)
    port = carry(DeformableAttention(**kw), variables)
    got = port_apply(port, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LAYER_ATOL)


@pytest.mark.parametrize("mode", ["dwc_pe", "fixed_pe", "log_cpb", "no_off"])
def test_deformable_attention_later_modes_raise(mode):
    """The position-bias modes besides the continuous one build and equal
    the JAX module in the forward (the geometry above; a config-time 6x6
    table against 8x12 queries), in the composite, not the kernel
    (``tests/test_torch_pe_modes.py`` holds their gradients)."""
    kw = dict(dim=32, n_heads=2, n_groups=2, stride=2, ksize=3, q_size=(6, 6), **{mode: True})
    jmod = JaxDeformableAttention(**kw)
    x = _x((2, 8, 12, 32), seed=6)
    variables = random_variables(jmod, x, seed=2)
    port = carry(DeformableAttention(**kw), variables)
    assert not port.runs_kernel()
    np.testing.assert_allclose(port_apply(port, x).numpy(), np.asarray(jax_apply(jmod, variables, x)),
                               rtol=0, atol=LAYER_ATOL)


# ----------------------------------------------------- backbone, segmentor --


@pytest.fixture(scope="module")
def small_pair():
    """The small SemanticFPN in both packages, one set of weights."""
    x = _x((2, 64, 96, 3), seed=7)
    jmodel = jax_build_model(small_fpn(jax_get_config))
    variables = random_variables(jmodel, x, seed=3, train=False)
    torch.manual_seed(0)
    pmodel = carry(build_model(small_fpn(get_config), device="cpu"), variables)
    return jmodel, variables, pmodel, x


def test_backbone_features_match_jax(small_pair):
    jmodel, variables, pmodel, x = small_pair
    jbb = jax_build_backbone(small_fpn(jax_get_config).backbone)
    ref = jax_apply(jbb, {"params": variables["params"]["backbone"]}, x)
    got = port_apply(pmodel.backbone, x)
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=MODEL_ATOL,
                                   err_msg=f"stage {i}")


@pytest.mark.parametrize("upsample", [True, False])
def test_fpn_segmentor_matches_jax(small_pair, upsample):
    jmodel, variables, pmodel, x = small_pair
    ref = np.asarray(jax_apply(jmodel, variables, x, train=False, upsample=upsample))
    got = port_apply(pmodel, x, upsample=upsample).numpy()
    assert got.shape == ref.shape == ((2, 64, 96, 8) if upsample else (2, 16, 24, 8))
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODEL_ATOL)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.99


def test_flagship_preset_has_14_deformable_blocks():
    """14 'D' blocks: 14 launches of K1 per forward on the card."""
    spec = get_config("fpn_tiny_80k_dp04_lr2").model.backbone.stage_spec
    assert sum(s.count("D") for s in spec) == 14
    assert sum(len(s) for s in spec) == 26


def test_head_registry_and_build_model_from_config():
    """``register_head`` adds a head type that ``build_model`` then builds;
    ``build_model_from_config`` takes a preset name, its TrainConfig or its
    ModelConfig and builds what ``build_model`` builds (the same modules
    and, from one seed, the same weights)."""
    import dataclasses

    from dat_segmentation_tpu_torch import build_model_from_config, register_head
    from dat_segmentation_tpu_torch.models import builder

    name = "upn_tiny_160k_dp03_lr6"
    want = build_model(get_config(name).model, device="cpu")
    for arg in (name, get_config(name), get_config(name).model):
        torch.manual_seed(0)
        got = build_model_from_config(arg, device="cpu")
        torch.manual_seed(0)
        ref = build_model(get_config(name).model, device="cpu")
        assert [n for n, _ in got.named_modules()] == [n for n, _ in want.named_modules()]
        assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                      ref.state_dict().values()))
    seen = []

    class LastLevelFCN(th.FCNHead):
        def forward(self, feats):
            return super().forward(feats[-1])

    @register_head("LastLevelFCN")
    def _fcn(cfg, in_channels, align_corners=False):
        seen.append(in_channels)
        return LastLevelFCN(in_channels[-1], cfg.num_classes, 8, dropout_ratio=0.0)

    try:
        cfg = small_upernet(get_config)
        cfg = dataclasses.replace(cfg, decode_head=dataclasses.replace(
            cfg.decode_head, type="LastLevelFCN"), auxiliary_head=None)
        model = build_model(cfg, device="cpu")
        assert isinstance(model.decode_head, LastLevelFCN) and seen == [[32, 32, 64, 64]]
        assert port_apply(model, _x((1, 64, 64, 3))).shape == (1, 64, 64, 8)
    finally:
        builder._HEAD_REGISTRY.pop("LastLevelFCN")


def test_build_model_refuses_other_heads():
    """UperNet (with its FCN auxiliary head) builds, and so does the
    classifier: a DatClassifier whose ClsHead reads the last stage's 512
    channels into 1000 classes, in eval mode; an unknown head is refused."""
    import dataclasses

    from dat_segmentation_tpu_torch.models.segmentor import DatClassifier

    model = build_model(get_config("upn_tiny_160k_dp03_lr6").model, device="cpu")
    assert isinstance(model.decode_head, th.UPerHead)
    assert isinstance(model.auxiliary_head, th.FCNHead)
    cfg = get_config("cls_tiny_imagenet").model
    cls = build_model(cfg, device="cpu")
    assert isinstance(cls, DatClassifier) and isinstance(cls.head, th.ClsHead)
    assert not cls.training and cls.head.fc.weight.shape == (1000, 512)
    assert cls.head.norm.normalized_shape == (512,)
    bad = dataclasses.replace(cfg, decode_head=dataclasses.replace(cfg.decode_head, type="Nope"))
    with pytest.raises(ValueError, match="unknown head"):
        build_model(bad, device="cpu")


# ------------------------------------------------------------------ heads --

_FEATS = [(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 16), (2, 2, 2, 32)]


def _feats(seed=9):
    return [_x(s, seed=seed + i) for i, s in enumerate(_FEATS)]


def _run_head(jmod, port, inputs, train):
    """JAX head (train: BN batch statistics, batch_stats updated) and the
    carried port head on the same inputs; returns both outputs and, in
    train mode, the updated JAX batch_stats."""
    import jax
    import jax.numpy as jnp

    variables = random_variables(jmod, inputs, seed=5)
    port = carry(port, variables).train(train)
    kw = dict(train=True, mutable=["batch_stats"]) if train else dict(train=False)
    out = jax.jit(lambda v, a: jmod.apply(v, a, **kw))(
        jax.tree_util.tree_map(jnp.asarray, variables), jax.tree_util.tree_map(jnp.asarray, inputs)
    )
    ref, upd = out if train else (out, None)
    with torch.no_grad():
        arg = [torch.from_numpy(f) for f in inputs] if isinstance(inputs, list) else torch.from_numpy(inputs)
        got = port(arg)
    return got, ref, port, upd


def _assert_stats(port, upd, rtol=0.0):
    """Running statistics against the updated JAX batch_stats, to 1e-6 (and
    ``rtol`` where deep features carry float32 rounding from the layers
    before them)."""
    want = convert_variables({"batch_stats": upd["batch_stats"]})
    got = port.state_dict()
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("topdown", ["mmseg", "standalone"])
def test_uperhead_matches_jax(topdown, train):
    jmod = jh.UPerHead(num_classes=5, channels=16, dropout_ratio=0.0, topdown=topdown)
    port = th.UPerHead([8, 16, 16, 32], 5, 16, dropout_ratio=0.0, topdown=topdown)
    got, ref, port, upd = _run_head(jmod, port, _feats(), train)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LAYER_ATOL * 10)
    if train:
        _assert_stats(port, upd, rtol=1e-5)  # fpn_i's BN sits three convs deep


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fcnhead_matches_jax(train):
    jmod = jh.FCNHead(num_classes=5, channels=8, num_convs=2, dropout_ratio=0.0)
    port = th.FCNHead(16, 5, 8, num_convs=2, dropout_ratio=0.0)
    got, ref, port, upd = _run_head(jmod, port, _x((2, 8, 8, 16), seed=11), train)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LAYER_ATOL)
    if train:
        _assert_stats(port, upd)


@pytest.mark.parametrize("topdown", ["mmseg", "standalone"])
def test_upernet_segmentor_train_outputs_match_jax(topdown):
    """The small UperNet in training: ``(logits, aux)`` both at the input
    size, against JAX ``train=True`` (drop path and dropout 0), and the
    updated BN statistics."""
    x = _x((2, 64, 64, 3), seed=12)
    jmodel = jax_build_model(small_upernet(jax_get_config, topdown=topdown))
    variables = random_variables(jmodel, x, seed=6, train=False)
    (ref, ref_aux), upd = jax_apply(jmodel, variables, x, train=True, mutable=["batch_stats"])
    torch.manual_seed(0)
    pmodel = carry(build_model(small_upernet(get_config, topdown=topdown), device="cpu"), variables)
    pmodel.train()
    with torch.no_grad():
        got, got_aux = pmodel(torch.from_numpy(x))
    assert got.shape == got_aux.shape == (2, 64, 64, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=MODEL_ATOL)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(ref_aux), rtol=0, atol=MODEL_ATOL)
    _assert_stats(pmodel, upd, rtol=1e-5)
    pmodel.eval()
    with torch.no_grad():
        assert pmodel(torch.from_numpy(x)).shape == (2, 64, 64, 8)  # eval: logits only


def test_build_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(small_fpn(get_config))
