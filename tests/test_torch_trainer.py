"""The port's segmentation trainer against the JAX package's, on the CPU.

One module-scoped fixture trains the small UperNet (150 classes; drop path
and dropout 0, float32, batch 2, 64² crops, 6 iterations, a log line
every iteration, checkpoints at 3 and 6, val at 6 on one image) with the
JAX ``train_segmentation`` and the port's, on the committed fixture's six
images as both splits. Both start from one set of weights: JAX variables
drawn from a numpy seed, carried into the port and written as a
mmseg-schema ``.pth`` by ``tools/reference_schema.py``, which both
trainers load as ``pretrained``. The JAX dataset reads through the port's
decoder (Pillow's JPEG decode differs from cv2's on a few pixels) and
augments on its native branch (``DAT_TPU_NATIVE=1``), the port's draw
order. Then a resumed pair: each package resumes from its own ``ckpt_3``
to 6 (the fresh run's ``ckpt_3``, copied: a 3-iteration run of the same
config takes the same first three steps, since the schedule follows
``schedule.max_iters``).

Losses per step agree to rtol 1e-4 (float32 on both sides, summed in other
orders: the step's own comparison, ``test_torch_train.py``, holds 1e-5 over
three steps); the in-run val class maps, fresh and resumed, are equal but
where the top two logits are within the packages' logit difference. The rest is the port alone:
a SIGTERM run, ``CheckpointManager``, ``MetricLogger``'s files, the mmseg
config copy against the JAX one, and the train -> test CLI loop.
"""

import dataclasses
import json
import shutil
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from dat_segmentation_tpu import native as jax_native
from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.configs.schema import replace as jax_replace
from dat_segmentation_tpu.data.ade20k import ADE20KDataset as JaxADE20KDataset
from dat_segmentation_tpu.data.ade20k import reduce_zero_label as jax_reduce_zero_label
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.train import trainer_seg as jax_trainer
from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.configs.schema import replace
from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
from dat_segmentation_tpu_torch.data.image_io import imread_gray, imread_rgb
from dat_segmentation_tpu_torch.tools.reference_schema import save_reference
from dat_segmentation_tpu_torch.train import trainer_seg
from dat_segmentation_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_pretrained,
    save_backbone_only,
)
from dat_segmentation_tpu_torch.utils.logging import MetricLogger, weight_stats
from torch_port_helpers import carry, random_variables, small_upernet

ROOT = Path(__file__).resolve().parent / "data" / "ade20k_tiny"
LOSS_RTOL = 1e-4
# AdamW moves a weight whose gradient is at rounding level by about lr a
# step whatever its size, so six steps at lr <= 6e-5 part such weights by up
# to 3.6e-4 between the packages; the val logits (largest about 3) then
# differ by about 1e-3 (9.9e-4 measured).
LOGIT_ATOL = 3e-3
OVERRIDES = {
    "data.batch_size": 2, "data.crop_size": (64, 64), "data.num_workers": 2,
    "schedule.max_iters": 6, "schedule.warmup_iters": 0,
    "log_interval": 1, "checkpoint_interval": 3, "eval_interval": 6, "dtype": "float32",
    "mesh_shape": {"data": 1}, "name": "parity",
}


class _JaxDatasetPortDecoder(JaxADE20KDataset):
    """The JAX dataset reading through the port's decoder."""

    def load_raw(self, idx):
        mask = imread_gray(self.masks[idx])
        return imread_rgb(self.images[idx]), jax_reduce_zero_label(mask, self.ignore_index)


def _layout(root, splits=("training", "validation")):
    """The fixture's six images (and masks) as each of ``splits``."""
    for split in splits:
        for kind, suffix in (("images", ".jpg"), ("annotations", ".png")):
            (root / kind / split).mkdir(parents=True)
            for p in sorted((ROOT / kind / "validation").glob(f"*{suffix}")):
                (root / kind / split / p.name).symlink_to(p)
    return root


def _cfgs(data, work):
    """Each package's config, writing under ``work/jax`` and ``work/port``."""
    kw = dict(OVERRIDES, **{"data.data_root": str(data)})
    jcfg = jax_get_config("upn_tiny_160k_dp03_lr6")
    jcfg = jax_replace(dataclasses.replace(jcfg, model=small_upernet(jax_get_config, num_classes=150)),
                       work_dir=str(work / "jax"), **kw)
    pcfg = get_config("upn_tiny_160k_dp03_lr6")
    pcfg = replace(dataclasses.replace(pcfg, model=small_upernet(get_config, num_classes=150)),
                   work_dir=str(work / "port"), **kw)
    return jcfg, pcfg


def _ckpt_names(work):
    return sorted(p.name for p in work.glob("ckpt_*"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    data = _layout(tmp / "data")
    jcfg, pcfg = _cfgs(data, tmp / "work")
    jmodel = jax_build_model(jcfg.model)
    variables = random_variables(jmodel, np.zeros((1, 64, 64, 3), np.float32), seed=11)
    pth = save_reference(carry(build_model(pcfg.model, device="cpu"), variables), pcfg.model,
                         tmp / "init.pth")
    evals = {"jax": [], "port": []}
    preds = {"jax": [], "port": []}  # one {image index: class map} an eval
    inferencers = {"jax": [], "port": []}
    out = {"evals": evals, "preds": preds, "inferencers": inferencers}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DAT_TPU_NATIVE", "1")
        assert jax_native.enabled(), "the JAX package's libimageops.so did not build"
        for name, mod in (("jax", jax_trainer), ("port", trainer_seg)):
            real = mod.evaluate_dataset

            def kept(inf, ds, *a, _real=real, _into=evals[name], _maps=preds[name],
                     _infs=inferencers[name], **k):
                _infs.append((inf, ds))
                _maps.append({})
                _into.append(_real(inf, ds, *a, on_pred=lambda i, p: _maps[-1].setdefault(i, np.array(p)),
                                   **k))
                return _into[-1]

            mp.setattr(mod, "evaluate_dataset", kept)
        common = dict(pretrained=str(pth), eval_max_images=1)
        out["jax"] = jax_trainer.train_segmentation(
            jcfg, dataset_cls=_JaxDatasetPortDecoder, **common)
        out["port"] = trainer_seg.train_segmentation(pcfg, device="cpu", **common)
        # the resumed pair: each package's own ckpt_3, then --resume to 6
        for name, cfg, rep, train, kw in (
            ("jax", jcfg, jax_replace, jax_trainer.train_segmentation,
             dict(dataset_cls=_JaxDatasetPortDecoder)),
            ("port", pcfg, replace, trainer_seg.train_segmentation, dict(device="cpu")),
        ):
            resumed = tmp / "resumed" / name
            shutil.copytree(Path(cfg.work_dir) / cfg.name / "ckpt_3", resumed / cfg.name / "ckpt_3")
            out[f"{name}_resumed"] = train(rep(cfg, work_dir=str(resumed)), resume=True,
                                           max_iters=6, eval_max_images=1, **kw)
    out.update(tmp=tmp, work=tmp / "work", pcfg=pcfg)
    return out


def test_losses_per_step_match_jax(runs):
    (_, jhist), (pstate, phist) = runs["jax"], runs["port"]
    assert len(phist["loss"]) == len(jhist["loss"]) == 6
    assert all(np.isfinite(phist["loss"]))
    np.testing.assert_allclose(phist["loss"], jhist["loss"], rtol=LOSS_RTOL)
    assert phist["loss"][0] != phist["loss"][-1]  # the weights moved
    assert pstate.step == 6


def _val_counts_equal_jax(runs, k, hists):
    """The ``k``-th in-run val (iteration 6), on the first image (512x512:
    its class map is the argmax of the logits at their own size). The
    weights after six steps differ in float32 rounding (the losses agree to
    about 1e-5), so the two packages' logits differ by up to some d, held
    under LOGIT_ATOL; a pixel may flip only where the port's top two logits
    are within 2 d, and the counts differ by at most one a flipped pixel in
    inter and two in union (the rule of test_torch_evaluate.py)."""
    (_, jhist), (_, phist) = hists
    j, p = runs["evals"]["jax"][k], runs["evals"]["port"][k]
    assert p["num_images"] == j["num_images"] == 1
    (jpred,), (ppred,) = runs["preds"]["jax"][k].values(), runs["preds"]["port"][k].values()
    assert jpred.shape == ppred.shape == (512, 512)
    logits = {}
    for name in ("jax", "port"):
        inf, ds = runs["inferencers"][name][k]
        raw, _ = ds.load_raw(0)
        (inp, _), = inf.tta_inputs(raw)
        logits[name] = np.asarray(inf.logits(np.asarray(inp) if name == "jax" else inp))
    assert logits["port"].shape == (512, 512, 150)
    np.testing.assert_array_equal(logits["port"].argmax(-1), ppred)
    d = np.abs(logits["port"] - logits["jax"]).max()
    assert d <= LOGIT_ATOL, d
    top2 = np.sort(logits["port"], axis=-1)[..., -2:]
    flips = jpred != ppred
    assert np.all(top2[..., 1][flips] - top2[..., 0][flips] <= 2 * d)
    flipped = int(flips.sum())
    d_inter = np.abs(np.subtract(p["inter"], j["inter"])).sum()
    d_union = np.abs(np.subtract(p["union"], j["union"])).sum()
    assert d_inter <= flipped and d_union <= 2 * flipped, (d_inter, d_union, flipped)
    if flipped == 0:
        assert p["inter"] == j["inter"] and phist["val_miou"] == jhist["val_miou"]


def test_val_counts_equal_jax(runs):
    """The fresh run's in-run val (see ``_val_counts_equal_jax``)."""
    _val_counts_equal_jax(runs, 0, (runs["jax"], runs["port"]))


def test_resumed_val_counts_equal_jax(runs):
    """The resumed run's in-run val, under the fresh run's rule."""
    assert len(runs["evals"]["jax"]) == len(runs["evals"]["port"]) == 2
    _val_counts_equal_jax(runs, 1, (runs["jax_resumed"], runs["port_resumed"]))


def test_checkpoint_names_equal_jax(runs):
    work = runs["work"]
    names = _ckpt_names(work / "port" / "parity")
    assert names == _ckpt_names(work / "jax" / "parity")
    assert names == ["ckpt_3", "ckpt_3.meta.json", "ckpt_6", "ckpt_6.meta.json", "ckpt_best",
                     "ckpt_best.meta.json"]
    meta = json.loads((work / "port" / "parity" / "ckpt_6.meta.json").read_text())
    assert meta["iter"] == 6 and len(meta["CLASSES"]) == 150 and "config" in meta


def test_resumed_losses_match_jax(runs):
    (jstate, jhist), (pstate, phist) = runs["jax_resumed"], runs["port_resumed"]
    assert len(phist["loss"]) == len(jhist["loss"]) == 3
    np.testing.assert_allclose(phist["loss"], jhist["loss"], rtol=LOSS_RTOL)
    assert pstate.step == int(jstate.step) == 6
    log = (runs["tmp"] / "resumed" / "port" / "parity" / "train.log").read_text()
    assert "resumed from iter 3" in log and "iter 6/6" in log and "iter 3/6" not in log


def test_checkpoint_restores_the_state_bit_for_bit(runs):
    """ckpt_6 of the fresh run holds the end state: model, AdamW, step and
    the drop-path generator."""
    state = runs["port"][0]
    run_dir = runs["work"] / "port" / "parity"
    saved = CheckpointManager(run_dir).restore(6)
    assert saved["step"] == state.step == 6
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    opt = state.optimizer.state_dict()
    assert saved["optimizer"]["param_groups"] == opt["param_groups"]
    for i, st in opt["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(saved["optimizer"]["state"][i][k]), torch.as_tensor(v))
    assert torch.equal(saved["generator"], state.generator.get_state())
    best = load_pretrained(str(run_dir / "ckpt_best"), runs["pcfg"].model)
    assert set(best) == set(state.model.state_dict())


def test_sigterm_checkpoints_and_exits(tmp_path):
    """SIGTERM mid-run -> one resumable checkpoint at the current iteration
    and a clean exit; --resume continues from it."""

    class _SignalingADE(ADE20KDataset):
        served = 0

        def __getitem__(self, idx):
            if self.is_train:
                _SignalingADE.served += 1
                if _SignalingADE.served == 5:
                    signal.raise_signal(signal.SIGTERM)
            return super().__getitem__(idx)

    data = _layout(tmp_path / "data")
    cfg = get_config("upn_tiny_160k_dp03_lr6")
    cfg = replace(dataclasses.replace(cfg, model=small_upernet(get_config, num_classes=150)), **dict(
        OVERRIDES, **{"data.data_root": str(data), "work_dir": str(tmp_path / "work"),
                      "data.num_workers": 1, "schedule.max_iters": 50, "log_interval": 100,
                      "checkpoint_interval": 1000, "eval_interval": 1000, "name": "preempt"}))
    before = signal.getsignal(signal.SIGTERM)
    state, _ = trainer_seg.train_segmentation(cfg, max_iters=50, eval_max_images=1,
                                              dataset_cls=_SignalingADE, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    stopped_at = state.step
    assert 0 < stopped_at < 50
    work = tmp_path / "work" / "preempt"
    assert [p.name for p in work.glob("ckpt_*") if p.is_dir()] == [f"ckpt_{stopped_at}"]
    meta = json.loads((work / f"ckpt_{stopped_at}.meta.json").read_text())
    assert meta["preempted"] is True and meta["iter"] == stopped_at
    state, _ = trainer_seg.train_segmentation(cfg, resume=True, max_iters=stopped_at + 1,
                                              eval_max_images=1, device="cpu")
    assert state.step == stopped_at + 1
    assert f"resumed from iter {stopped_at}" in (work / "train.log").read_text()


def test_one_device_only(tmp_path):
    """Without a process group the trainer runs on one device: a data axis
    larger than one, fsdp and a spatial axis need the group
    (tests/test_torch_parallel.py and tests/test_torch_spatial_axis.py run
    them over processes)."""
    cfg = replace(get_config("upn_tiny_160k_dp03_lr6"), mesh_shape={"data": 4})
    with pytest.raises(ValueError, match="group of 1 processes"):
        trainer_seg.train_segmentation(cfg, device="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        trainer_seg.train_segmentation(replace(cfg, mesh_shape={"data": 1}, fsdp=True),
                                       device="cpu")
    with pytest.raises(ValueError, match="group of 1 processes"):
        trainer_seg.train_segmentation(replace(cfg, mesh_shape={"data": -1, "spatial": 2}),
                                       device="cpu")


def _sd(seed):
    g = torch.Generator().manual_seed(seed)
    return {"backbone.w": torch.randn(4, 4, generator=g), "decode_head.b": torch.randn(3, generator=g)}


def test_checkpoint_manager_gc_best_and_backbone_export(tmp_path):
    mgr = CheckpointManager(tmp_path / "run", max_to_keep=2)
    mgr.save("best", {"model": _sd(0)}, metadata={"iter": 0})
    for s in (1, 2, 3, 4):
        mgr.save(s, {"step": s, "model": _sd(s)}, metadata={"iter": s})
    assert mgr.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "ckpt_3", "ckpt_3.meta.json", "ckpt_4", "ckpt_4.meta.json", "ckpt_best",
        "ckpt_best.meta.json"]
    out = mgr.restore(3)
    assert out["step"] == 3 and torch.equal(out["model"]["backbone.w"], _sd(3)["backbone.w"])
    with pytest.raises(FileExistsError):
        mgr.save(3, {"step": 3}, overwrite=False)
    bb = save_backbone_only(tmp_path / "bb", _sd(5))
    loaded = load_pretrained(str(bb), None, kind="backbone")
    assert list(loaded) == ["backbone.w"] and torch.equal(loaded["backbone.w"], _sd(5)["backbone.w"])
    with pytest.raises(ValueError, match="needs JAX"):  # an orbax directory
        load_pretrained(str(tmp_path), None)


def test_metric_logger_writes_tb_and_jsonl_and_weight_stats(tmp_path):
    """Pattern tests/test_observability.py: the jsonl and the TB events read
    back; weight_stats against the JAX package's on the same arrays."""
    from dat_segmentation_tpu.utils.logging import weight_stats as jax_weight_stats
    from test_observability import _decode_scalars, _read_records

    logger = MetricLogger(tmp_path / "run" / "train.log", quiet=True)
    logger.log("iter 1/2 loss=1.0000")
    logger.scalars(5, loss=2.0, lr=1e-4)
    logger.scalars(10, loss=1.0, lr=9e-5, val_miou=0.4)
    logger.close()
    lines = [json.loads(ln) for ln in (tmp_path / "run" / "train.scalars.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [5, 10] and lines[1]["val_miou"] == 0.4
    assert (tmp_path / "run" / "train.log").read_text().strip().endswith("iter 1/2 loss=1.0000")
    ev_files = list((tmp_path / "run" / "tb").glob("events.out.tfevents.*"))
    assert len(ev_files) == 1
    steps_scalars = [_decode_scalars(r) for r in _read_records(ev_files[0])[1:]]
    assert steps_scalars[0][0] == 5 and steps_scalars[0][1]["loss"] == pytest.approx(2.0)
    assert steps_scalars[1][1]["val_miou"] == pytest.approx(0.4)

    rng = np.random.RandomState(0)
    arrays = {"layer.kernel": rng.randn(8, 16).astype(np.float32),
              "bias": rng.randn(16).astype(np.float32)}
    got = weight_stats({k: torch.from_numpy(v) for k, v in arrays.items()})
    ref = jax_weight_stats({"layer": {"kernel": arrays["layer.kernel"]}, "bias": arrays["bias"]})
    assert set(got) == {"layer.kernel", "bias"}
    for name, key in (("layer.kernel", "layer/kernel"), ("bias", "bias")):
        for stat in ("mean", "std", "l2"):
            assert got[name][stat] == pytest.approx(ref[key][stat], rel=1e-5, abs=1e-7)


def test_mmseg_config_copy_equals_jax(tmp_path):
    """Pattern tests/test_configs.py: a config with a _base_ file and a
    _delete_ key, through both packages' mmseg readers, and through the
    port's train CLI's load_config."""
    from dat_segmentation_tpu.configs.mmseg_compat import (
        load_mmseg_config as jax_load_mmseg_config,
        load_python_config as jax_load_python_config,
        model_config_from_mmseg as jax_model_config_from_mmseg,
    )
    from dat_segmentation_tpu_torch.configs.mmseg_compat import (
        load_mmseg_config, load_python_config, model_config_from_mmseg)
    from dat_segmentation_tpu_torch.tools.train import load_config

    (tmp_path / "_base_").mkdir()
    (tmp_path / "_base_" / "model.py").write_text(
        "model = dict(backbone=dict(type='DAT', dims=[64, 128, 256, 512], depths=[2, 4, 18, 2],\n"
        "             drop_path_rate=0.2, init_cfg=None),\n"
        "             decode_head=dict(type='UPerHead', channels=512, num_classes=150),\n"
        "             auxiliary_head=dict(type='FCNHead', channels=256, in_index=2,\n"
        "                                 loss_decode=dict(loss_weight=0.4)),\n"
        "             test_cfg=dict(mode='whole'))\n"
        "optimizer = dict(type='SGD', lr=0.01, momentum=0.9)\n")
    cfg_py = tmp_path / "small_dat.py"
    cfg_py.write_text(
        "_base_ = ['_base_/model.py']\n"
        "model = dict(backbone=dict(dims=[32, 64, 128, 256], stage_spec=[['X', 'D'], ['D'],\n"
        "             ['D'], ['D']], use_pes=[True] * 4),\n"
        "             decode_head=dict(num_classes=19), test_cfg=dict(mode='slide'))\n"
        "optimizer = dict(_delete_=True, type='AdamW', lr=6e-5)\n")
    assert load_mmseg_config(str(cfg_py)) == jax_load_mmseg_config(str(cfg_py))
    got = model_config_from_mmseg(load_python_config(str(cfg_py)))
    ref = jax_model_config_from_mmseg(jax_load_python_config(str(cfg_py)))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.backbone.dims == (32, 64, 128, 256) and got.test_mode == "slide"
    train_cfg = load_config(str(cfg_py))
    assert train_cfg.name == "small_dat" and train_cfg.model == got


def test_train_then_test_cli(tmp_path, capsys, monkeypatch):
    """Pattern tests/test_cli.py: the port's train CLI for 3 iterations on
    the CPU, then its test CLI on the ckpt_3 directory it wrote, both with
    --set; the CLI's result equals evaluate_dataset's on the checkpoint's
    weights. A ClsHead config goes to the classifier trainer with
    --epochs and --no-mixup; a host without a card is refused unless
    --device cpu is given."""
    from dat_segmentation_tpu_torch.eval.evaluate import evaluate_dataset
    from dat_segmentation_tpu_torch.eval.inference import SegInferencer
    from dat_segmentation_tpu_torch.tools import test as test_cli
    from dat_segmentation_tpu_torch.tools import train as train_cli

    data = _layout(tmp_path / "data")
    bb = small_upernet(get_config, num_classes=150).backbone
    sets = [f"model.backbone.{f}={getattr(bb, f)!r}"
            for f in ("dims", "dim_stem", "depths", "heads", "groups", "stage_spec")] + [
        "model.decode_head.channels=32", "model.auxiliary_head.channels=16",
        "data.batch_size=2", "data.crop_size=(64,64)", "data.num_workers=2",
        "schedule.warmup_iters=0", "log_interval=1", "checkpoint_interval=3",
        "eval_interval=1000", "dtype=float32", "mesh_shape={'data':1}"]
    work = tmp_path / "work"
    state, hist = train_cli.main(["upn_tiny_160k_dp03_lr6", "--data-root", str(data),
                                  "--work-dir", str(work), "--max-iters", "3", "--device", "cpu",
                                  "--set", *sets])
    assert state.step == 3 and len(hist["loss"]) == 3 and len(hist["val_miou"]) == 1
    ckpt = work / "upn_tiny_160k_dp03_lr6" / "ckpt_3"
    assert ckpt.is_dir()
    out = tmp_path / "r.json"
    res = test_cli.main(["upn_tiny_160k_dp03_lr6", str(ckpt), "--data-root", str(data),
                         "--max-images", "2", "--batch-size", "1", "--out", str(out),
                         "--device", "cpu", "--set", *sets[:8]])
    assert "missing 0, unexpected 0, mismatched 0" in capsys.readouterr().out
    assert 0.0 <= res["mIoU"] <= 1.0 and res["num_images"] == 2
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    direct = evaluate_dataset(SegInferencer(state.model, num_classes=150, device="cpu"),
                              ADE20KDataset(data, "val"), max_images=2, verbose=False)
    assert res["inter"] == direct["inter"] and res["union"] == direct["union"]
    from dat_segmentation_tpu_torch.train import trainer_cls

    calls = []
    monkeypatch.setattr(trainer_cls, "train_classifier",
                        lambda cfg, **kw: calls.append((cfg, kw)) or "trained")
    assert train_cli.main(["cls_tiny_imagenet", "--data-root", str(data), "--device", "cpu",
                           "--epochs", "2", "--no-mixup"]) == "trained"
    (cfg, kw), = calls
    assert cfg.model.decode_head.type == "ClsHead" and cfg.data.data_root == str(data)
    assert kw["epochs"] == 2 and kw["mixup"] is False and kw["device"] == torch.device("cpu")
    if not torch.cuda.is_available():  # the card unless the CPU is asked for
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["upn_tiny_160k_dp03_lr6", "--data-root", str(data)])

