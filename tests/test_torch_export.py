"""The port's serving export against the JAX package, on the CPU.

Small models (``torch_port_helpers.small_fpn`` with 8 classes and
``small_classifier``), their JAX variables drawn from a numpy seed and
carried into the port (``utils/convert.py``), are exported with
``torch.export`` and loaded with ``ServingModel``. The artifact is held to
the JAX package's *live* model (``apply(..., upsample=False)``, float32,
one jit a model for the module), never to a ``jax.export`` artifact (the
JAX package's own export tests pay for those compiles): atol 1e-4, as
``tests/test_torch_models.py`` holds the same logits. ``predict_semseg``
is held to the JAX ``predict_semseg``'s steps (normalise, zero-pad, the
JAX forward, ``_resize_bilinear``'s numpy path, argmax): equal but at
logit near-ties (top two within 2e-4, twice the logits' agreement).
``_pick_entry`` and the ``format_version`` rule are held to the JAX
``ServingModel`` on one manifest. Also: K1's op in every graph and K3's
with ``portable=False`` on a ``'pallas'`` config; a fresh process that
loads and runs an artifact without importing ``models/``; a CUDA entry on
a host without ``nvcc`` raising, naming the kernel, with no plain version
run; ``tools/export.py --check`` and ``tools/convert.py`` end to end; and
``tools/test.py --show-dir/--format-dir`` PNGs, read back by cv2, against
the JAX CLI's on ``tests/data/ade20k_tiny``.
"""

import dataclasses
import functools
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dat_segmentation_tpu.eval as jax_eval
import dat_segmentation_tpu.models as jax_models
from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.serving import ServingModel as JaxServingModel
from dat_segmentation_tpu.serving.export import _resize_bilinear as jax_resize_bilinear
from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.data.ade20k import IMG_NORM_MEAN, IMG_NORM_STD
from dat_segmentation_tpu_torch.eval.inference import SegInferencer
from dat_segmentation_tpu_torch.ops import deform_attn as da
from dat_segmentation_tpu_torch.serving import (ServingModel, export_classifier,
                                                export_segmentor, save_artifact)
from dat_segmentation_tpu_torch.tools import convert as convert_cli
from dat_segmentation_tpu_torch.tools import export as export_cli
from dat_segmentation_tpu_torch.tools import test as test_cli
from dat_segmentation_tpu_torch.tools import train as train_cli
from dat_segmentation_tpu_torch.tools.reference_schema import save_reference, to_reference
from dat_segmentation_tpu_torch.train.checkpoint import load_pretrained
from torch_port_helpers import (ShapeInit, carry, jax_reference_keys, random_variables,
                                small_classifier, small_fpn)

ROOT = Path(__file__).resolve().parent.parent
ADE_TINY = ROOT / "tests" / "data" / "ade20k_tiny"
MODEL_ATOL = 1e-4
LOGIT_TIE = 2e-4
MAX_FLIPPED = 1e-4  # share of the pixels, as tests/test_torch_evaluate.py
SIDE = 64
JAX_META_KEYS = {"format_version", "task", "entries", "output_stride", "norm_mean", "norm_std",
                 "num_classes", "model_config"}
ENTRY_KEYS = {"file", "input_shape", "input_dtype", "output_shape", "output_dtype", "device",
              "bytes", "kernels"}


def _jax_fn(jmodel, variables, **kwargs):
    fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, **kwargs))
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    return lambda x: np.asarray(fn(v, jnp.asarray(x)))


def _padded_image(raw):
    norm = (raw.astype(np.float32) - IMG_NORM_MEAN) / IMG_NORM_STD
    padded = np.zeros((2, SIDE, SIDE, 3), np.float32)
    padded[0, : raw.shape[0], : raw.shape[1]] = norm
    return padded


@pytest.fixture(scope="module")
def fpn(tmp_path_factory):
    """The small FPN in both packages, its float32 artifact (one 64x64
    entry of batch 2, portable) and the JAX live logits on a seeded input
    and on the padded 50x60 image, in one JAX call."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, SIDE, SIDE, 3).astype(np.float32)
    raw = rng.randint(0, 256, (50, 60, 3)).astype(np.uint8)
    jmodel = jax_build_model(small_fpn(jax_get_config))
    variables = random_variables(jmodel, x, seed=4, train=False)
    jax_out = _jax_fn(jmodel, variables, upsample=False)(np.concatenate([x, _padded_image(raw)]))
    cfg = small_fpn(get_config)
    torch.manual_seed(0)
    pmodel = carry(build_model(cfg, device="cpu"), variables)
    art = tmp_path_factory.mktemp("fpn_art")
    entry = export_segmentor(cfg, pmodel.state_dict(), batch=2, input_size=(SIDE, SIDE),
                             compute_dtype=torch.float32, device="cpu")
    save_artifact(art, {"seg": entry}, model_cfg=cfg, num_classes=cfg.num_classes)
    return dict(cfg=cfg, pmodel=pmodel, art=art, x=x, raw=raw, jax_x=jax_out[:2],
                jax_padded=jax_out[2:])


def test_segmentor_round_trip_matches_jax(fpn):
    """The manifest, the logits against the JAX model, and against the
    live server bit for bit: its model's weights require grad, the
    artifact's are frozen (a Linear on a strided input once took another
    matmul path by that flag, and summed in another order at batch 2)."""
    srv = ServingModel.load(fpn["art"])
    meta = srv.meta
    assert JAX_META_KEYS <= set(meta) and "torch_version" in meta and "jax_version" not in meta
    assert meta["task"] == "segmentor" and meta["output_stride"] == 4
    assert meta["num_classes"] == 8 and meta["model_config"]["num_classes"] == 8
    info = srv.entries["seg"]
    assert set(info) == ENTRY_KEYS
    assert info["input_shape"] == [2, SIDE, SIDE, 3] and info["input_dtype"] == "float32"
    assert info["output_shape"] == [2, SIDE // 4, SIDE // 4, 8]
    assert info["output_dtype"] == "float32" and info["device"] == "cpu"
    assert info["bytes"] == (fpn["art"] / info["file"]).stat().st_size
    got = srv("seg", fpn["x"])
    assert got.dtype == torch.float32 and list(got.shape) == info["output_shape"]
    np.testing.assert_allclose(got.numpy(), fpn["jax_x"], rtol=0, atol=MODEL_ATOL)
    live = SegInferencer(fpn["pmodel"], num_classes=8, compute_dtype=torch.float32,
                         device="cpu").forward_batch(fpn["x"])
    assert torch.equal(got, live)  # the same ops on the same device


def test_predict_semseg_matches_the_jax_pipeline(fpn, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # the JAX resize's numpy path
    logits = jax_resize_bilinear(fpn["jax_padded"][0], (SIDE, SIDE))[:50, :60]
    want = np.argmax(logits, axis=-1).astype(np.int32)
    got = ServingModel.load(fpn["art"]).predict_semseg(fpn["raw"])
    assert got.dtype == np.int32 and got.shape == (50, 60)
    differ = got != want
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0])[differ].max(initial=0.0) <= LOGIT_TIE
    assert differ.mean() <= 0.01, differ.sum()


def _manifest(directory, shapes, version=1):
    entries = {f"seg_{h}x{w}": {"file": f"seg_{h}x{w}.pt2", "input_shape": [1, h, w, 3],
                                "device": "cpu", "kernels": []} for h, w in shapes}
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "meta.json").write_text(json.dumps(
        {"format_version": version, "task": "segmentor", "entries": entries}))
    return directory


@pytest.mark.parametrize("hw,want", [((50, 60), "seg_64x64"), ((64, 64), "seg_64x64"),
                                     ((100, 60), "seg_128x64"), ((64, 65), None),
                                     ((129, 10), None)])
def test_pick_entry_as_jax(tmp_path, hw, want):
    d = _manifest(tmp_path / "art", [(64, 64), (128, 64)])
    port, ref = ServingModel.load(d), JaxServingModel.load(d)
    if want is None:
        for srv in (port, ref):
            with pytest.raises(ValueError, match="no exported entry fits"):
                srv._pick_entry(*hw)
    else:
        assert port._pick_entry(*hw) == ref._pick_entry(*hw) == want


def test_newer_format_is_refused_as_jax(tmp_path):
    d = _manifest(tmp_path / "art", [(64, 64)], version=2)
    for loader in (ServingModel, JaxServingModel):
        with pytest.raises(ValueError, match="newer than this loader"):
            loader.load(d)


def test_classifier_artifact_matches_jax(tmp_path):
    x = np.random.RandomState(5).randn(2, SIDE, SIDE, 3).astype(np.float32)
    jmodel = jax_build_model(small_classifier(jax_get_config))
    variables = random_variables(jmodel, x, seed=6, train=False)
    want = _jax_fn(jmodel, variables)(x)
    cfg = small_classifier(get_config)
    torch.manual_seed(0)
    pmodel = carry(build_model(cfg, device="cpu"), variables)
    entry = export_classifier(cfg, pmodel.state_dict(), batch=2, input_size=(SIDE, SIDE),
                              compute_dtype=torch.float32, device="cpu")
    srv = ServingModel.load(save_artifact(tmp_path, {"cls": entry}, task="classifier",
                                          model_cfg=cfg, num_classes=cfg.num_classes))
    assert srv.meta["output_stride"] is None
    assert srv.entries["cls"]["output_shape"] == [2, 10]
    assert srv.entries["cls"]["kernels"] == ["dat::deform_attn_fwd"]
    top, logits = srv.predict_cls(x)
    np.testing.assert_allclose(logits, want, rtol=0, atol=MODEL_ATOL)
    np.testing.assert_array_equal(top, np.argmax(logits, -1))
    with pytest.raises(ValueError, match="predict_semseg on a classifier"):
        srv.predict_semseg(np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("portable", [True, False], ids=["portable", "no_portable"])
def test_graph_holds_the_kernels(fpn, portable):
    """On a 'pallas' config: K1's op once a 'D' block (4), K3's once a
    block of the stages whose sides are multiples of 8 (64x64: stage 0's
    'D' block and stage 1's 'X' and 'D', 3) only without ``portable``;
    the output within float32 noise of the JAX model's either way."""
    cfg = fpn["cfg"]
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                kernel_impl="pallas"))
    program = export_segmentor(cfg, fpn["pmodel"].state_dict(), batch=2,
                               input_size=(SIDE, SIDE), compute_dtype=torch.float32,
                               device="cpu", portable=portable)
    calls = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert calls.count("dat.deform_attn_fwd.default") == 4
    assert calls.count("dat.x_block_fwd.default") == (0 if portable else 3)
    got = program.module()(torch.from_numpy(fpn["x"]))
    np.testing.assert_allclose(got.numpy(), fpn["jax_x"], rtol=0, atol=MODEL_ATOL)


def test_a_fresh_process_serves_without_the_model_code(fpn, tmp_path):
    np.save(tmp_path / "x.npy", fpn["x"])
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from dat_segmentation_tpu_torch.serving import ServingModel\n"
        f"srv = ServingModel.load({str(fpn['art'])!r})\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, srv('seg', np.load({str(tmp_path / 'x.npy')!r})).numpy())\n"
        f"np.save({str(tmp_path / 'm.npy')!r}, srv.predict_semseg(np.zeros((50, 60, 3), np.uint8)))\n"
        "print(sorted(m for m in sys.modules if m.startswith('dat_segmentation_tpu')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = eval(proc.stdout.strip().splitlines()[-1])
    assert "dat_segmentation_tpu_torch.serving" in modules
    assert not [m for m in modules if m.startswith("dat_segmentation_tpu_torch.models")
                or m.split(".")[0] == "dat_segmentation_tpu"], modules
    srv = ServingModel.load(fpn["art"])
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), srv("seg", fpn["x"]).numpy())
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"),
                                  srv.predict_semseg(np.zeros((50, 60, 3), np.uint8)))


def test_a_cuda_entry_without_nvcc_raises(fpn, tmp_path, monkeypatch):
    """No CUDA export can be made here: the manifest of the CPU artifact is
    rewritten to name the card. Loading the entry builds its kernels
    first; without nvcc that raises, naming the kernel, and no plain
    version runs."""
    art = shutil.copytree(fpn["art"], tmp_path / "art")
    meta = json.loads((art / "meta.json").read_text())
    meta["entries"]["seg"]["device"] = "cuda:0"
    (art / "meta.json").write_text(json.dumps(meta))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    ran = []
    monkeypatch.setattr(da, "deform_attn_reference", lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match=r"dat::deform_attn_fwd.*nvcc"):
        ServingModel.load(art)("seg", fpn["x"])
    assert not ran


def test_export_and_convert_clis(fpn, tmp_path, monkeypatch, capsys):
    """``tools/convert.py`` turns a reference .pth of the small FPN into the
    port's checkpoint directory (every tensor back, an empty report);
    ``tools/export.py --check`` exports from it, float32 on the CPU, and
    its artifact equals the live model bit for bit."""
    cfg = get_config("fpn_tiny_80k_dp04_lr2")
    small = dataclasses.replace(cfg, model=fpn["cfg"])
    monkeypatch.setattr(train_cli, "load_config", lambda name: small)
    pth = save_reference(fpn["pmodel"], fpn["cfg"], tmp_path / "fpn.pth")
    ckpt = convert_cli.main(["fpn_tiny_80k_dp04_lr2", str(pth), str(tmp_path / "ckpt")])
    assert "missing=0 unexpected=0 mismatched=0" in capsys.readouterr().out
    state = load_pretrained(str(ckpt), fpn["cfg"])
    own = fpn["pmodel"].state_dict()
    assert state.keys() == own.keys() and all(torch.equal(state[k], own[k]) for k in own)
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        convert_cli.main(["fpn_tiny_80k_dp04_lr2", str(pth), str(ckpt)])
    summary = export_cli.main(["fpn_tiny_80k_dp04_lr2", str(ckpt), "--output",
                               str(tmp_path / "art"), "--shapes", "64x64,64x96", "--dtype",
                               "float32", "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "missing 0, unexpected 0, mismatched 0" in out and "check OK" in out
    assert set(summary["entries"]) == {"seg_64x64_b1", "seg_64x96_b1"}
    for e in summary["entries"].values():
        assert e["check_rel"] == 0.0 and e["check_equal"]
        assert e["kernels"] == ["dat::deform_attn_fwd"] and e["device"] == "cpu"
    srv = ServingModel.load(tmp_path / "art")
    assert srv._pick_entry(60, 90) == "seg_64x96_b1"
    assert "palette" not in srv.meta  # 8 classes: no ADE20K names or colours


def test_show_and_format_dirs_match_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs on one mmseg-schema .pth of a 150-class small FPN, the
    first two fixture images at img_scale (128, 64), float32 on both sides
    (each CLI's inferencer told so). The PNGs, read back by cv2, are equal
    but at pixels where the two sides' class maps flip at logit near-ties
    (at most 1e-4 of them, as tests/test_torch_evaluate.py allows), and
    the colour and label maps flip at the same pixels."""
    cfg = get_config("fpn_tiny_80k_dp04_lr2")
    small = dataclasses.replace(cfg, model=small_fpn(get_config, num_classes=150),
                                data=dataclasses.replace(cfg.data, img_scale=(128, 64)))
    torch.manual_seed(7)
    model = build_model(small.model, device="cpu")
    pth = save_reference(model, small.model, tmp_path / "m.pth")
    jax_pth = tmp_path / "m_jax.pth"
    torch.save({"state_dict": jax_reference_keys(to_reference(model.state_dict(),
                                                                small.model))}, jax_pth)
    monkeypatch.setattr(test_cli, "load_config", lambda name: small)
    monkeypatch.setattr(test_cli, "SegInferencer",
                        functools.partial(SegInferencer, compute_dtype=torch.float32))
    port = {k: tmp_path / f"port_{k}" for k in ("show", "format")}
    test_cli.main(["fpn_tiny_80k_dp04_lr2", str(pth), "--data-root", str(ADE_TINY),
                   "--max-images", "2", "--show-dir", str(port["show"]), "--format-dir",
                   str(port["format"]), "--device", "cpu"])

    monkeypatch.syspath_prepend(str(ROOT))
    jax_test_cli = importlib.import_module("tools.test")
    jax_train_cli = importlib.import_module("tools.train")
    build = jax_models.build_model
    monkeypatch.setattr(jax_models, "build_model", lambda c: ShapeInit(build(c)))
    jax_small = dataclasses.replace(
        jax_get_config("fpn_tiny_80k_dp04_lr2"), model=small_fpn(jax_get_config, num_classes=150))
    jax_small = dataclasses.replace(jax_small, data=dataclasses.replace(jax_small.data,
                                                                        img_scale=(128, 64)))
    monkeypatch.setattr(jax_train_cli, "load_config", lambda name: jax_small)
    monkeypatch.setattr(jax_eval, "SegInferencer", functools.partial(
        jax_eval.SegInferencer, compute_dtype=jnp.float32, transfer_dtype=jnp.float32))
    ref = {k: tmp_path / f"jax_{k}" for k in ("show", "format")}
    monkeypatch.setattr(sys, "argv", [
        "tools/test.py", "fpn_tiny_80k_dp04_lr2", str(jax_pth), "--data-root", str(ADE_TINY),
        "--max-images", "2", "--show-dir", str(ref["show"]), "--format-dir", str(ref["format"])])
    jax_test_cli.main()

    names = sorted(p.name for p in ref["show"].iterdir())
    assert len(names) == 2
    for kind in ("show", "format"):
        assert sorted(p.name for p in port[kind].iterdir()) == names
    flipped = total = 0
    for name in names:
        show = [cv2.imread(str(d["show"] / name)) for d in (port, ref)]
        fmt = [cv2.imread(str(d["format"] / name), cv2.IMREAD_UNCHANGED) for d in (port, ref)]
        assert show[0].shape == show[1].shape and fmt[0].shape == fmt[1].shape == show[0].shape[:2]
        assert fmt[0].dtype == np.uint8 and fmt[0].min() >= 1
        differ = fmt[0] != fmt[1]
        np.testing.assert_array_equal((show[0] != show[1]).any(-1), differ)
        flipped, total = flipped + int(differ.sum()), total + differ.size
    assert flipped <= MAX_FLIPPED * total, (flipped, total)
