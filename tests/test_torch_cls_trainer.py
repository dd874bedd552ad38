"""The port's classifier trainer against the JAX package's, on the CPU.

One module-scoped fixture trains the small classifier of
``test_torch_cls_model.py`` (10 classes, drop path 0, no mixup, float32,
batch 4, 64² crops) for one epoch of two steps, with a log line and weight
statistics every step, on the committed fixture ``tests/data/imagenet_tiny``
(12 train and 6 val images, so the val's last batch is a padded tail of 2),
with the JAX ``train_classifier`` and the port's. Both start from one
reference ``.pth`` (JAX variables from a numpy seed, carried into the port
and written by ``tools/reference_schema.py``), loaded as ``pretrained``; the
JAX dataset reads through the port's decoder, and cv2 resizes on its
portable path (``test_torch_cls_data.py`` says why).

Losses per step agree to rtol 1e-4, as the seg trainer's; the val top-1 and
top-5 equal, but at a row whose label's rank the packages' logit difference
could flip; the checkpoint names and files are the JAX trainer's. The port
alone: a run preempted at step 2 of 4 (mixup on, drop path 0.1) and resumed
ends where the uninterrupted run ends, bit for bit.
"""

import dataclasses
import json
import random
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.configs.schema import replace as jax_replace
from dat_segmentation_tpu.data import imagenet as jax_imagenet
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu.train import trainer_cls as jax_trainer
from dat_segmentation_tpu_torch import build_model, get_config
from dat_segmentation_tpu_torch.configs.schema import replace
from dat_segmentation_tpu_torch.data.image_io import imread_rgb
from dat_segmentation_tpu_torch.data.imagenet import ImageNetDataset
from dat_segmentation_tpu_torch.tools.reference_schema import save_reference
from dat_segmentation_tpu_torch.train import trainer_cls
from dat_segmentation_tpu_torch.train.checkpoint import CheckpointManager, load_pretrained
from torch_port_helpers import carry, random_variables, small_classifier

ROOT = Path(__file__).resolve().parent / "data" / "imagenet_tiny"
LOSS_RTOL = 1e-4
OVERRIDES = {
    "data.batch_size": 4, "data.crop_size": (64, 64), "data.num_workers": 2,
    "schedule.warmup_iters": 0, "log_interval": 1, "dtype": "float32",
    "mesh_shape": {"data": 1}, "name": "parity",
}


class _JaxDatasetPortDecoder(jax_imagenet.ImageNetDataset):
    """The JAX dataset reading through the port's decoder, with cv2 on its
    portable path in the loader thread that calls it (OpenCV keeps the IPP
    switch per thread)."""

    def __getitem__(self, idx):
        cv2.ipp.setUseIPP(False)
        path, label = self.samples[idx]
        img = imread_rgb(path)
        if self.is_train:
            rng = random.Random(f"{self.seed}:{self.epoch}:{idx}")
            img = jax_imagenet.train_transform_cls(img, rng, size=self.size)
        else:
            img = jax_imagenet.val_transform_cls(img, size=self.size)
        return {"image": img, "label": np.int32(label)}


def _cfgs(work, **extra):
    kw = dict(OVERRIDES, **{"data.data_root": str(ROOT)}, **extra)
    jcfg = jax_get_config("cls_tiny_imagenet")
    jcfg = jax_replace(dataclasses.replace(jcfg, model=small_classifier(jax_get_config)),
                       work_dir=str(work / "jax"), **kw)
    pcfg = get_config("cls_tiny_imagenet")
    pcfg = replace(dataclasses.replace(pcfg, model=small_classifier(get_config)),
                   work_dir=str(work / "port"), **kw)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cls_trainer")
    jcfg, pcfg = _cfgs(tmp / "work")
    jmodel = jax_build_model(jcfg.model)
    variables = random_variables(jmodel, np.zeros((1, 64, 64, 3), np.float32), seed=11,
                                 train=False)
    pth = save_reference(carry(build_model(pcfg.model, device="cpu"), variables), pcfg.model,
                         tmp / "init.pth")
    common = dict(pretrained=str(pth), epochs=1, mixup=False, steps_per_epoch=2, stats_interval=1)
    was = cv2.ipp.useIPP()
    try:
        jax_run = jax_trainer.train_classifier(jcfg, dataset_cls=_JaxDatasetPortDecoder, **common)
    finally:
        cv2.ipp.setUseIPP(was)
    port_run = trainer_cls.train_classifier(pcfg, device="cpu", **common)
    return {"jax": jax_run, "port": port_run, "jmodel": jmodel, "jcfg": jcfg, "pcfg": pcfg,
            "work": tmp / "work"}


def test_losses_match_jax(runs):
    (jstate, jhist), (pstate, phist) = runs["jax"], runs["port"]
    assert len(phist["train_loss"]) == len(jhist["train_loss"]) == 1
    np.testing.assert_allclose(phist["train_loss"], jhist["train_loss"], rtol=LOSS_RTOL)
    assert pstate.step == int(jstate.step) == 2
    steps = [json.loads(line) for line in
             (runs["work"] / "port" / "parity" / "train.scalars.jsonl").read_text().splitlines()]
    jsteps = [json.loads(line) for line in
              (runs["work"] / "jax" / "parity" / "train.scalars.jsonl").read_text().splitlines()]
    losses = [s["loss"] for s in steps if "loss" in s]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, [s["loss"] for s in jsteps if "loss" in s], rtol=LOSS_RTOL)
    stats = [k for k in steps[0] if k.startswith("w/")]
    assert "w/head.fc.weight/l2" in stats and len(stats) == 3 * len(list(pstate.model.parameters()))


def _val_logits(runs):
    """Each package's final weights on the six val images."""
    jstate, _ = runs["jax"]
    pstate, _ = runs["port"]
    ds = ImageNetDataset(str(ROOT), "val", size=64)
    x = np.stack([ds[i]["image"] for i in range(len(ds))])
    label = np.array([ds[i]["label"] for i in range(len(ds))])
    with torch.no_grad():
        port = pstate.model.eval()(torch.from_numpy(x)).numpy()
    params = jax.tree_util.tree_map(jnp.asarray, jstate.params)
    fwd = jax.jit(lambda p, a: runs["jmodel"].apply({"params": p}, a, train=False))
    return port, np.asarray(fwd(params, jnp.asarray(x))), label


def test_val_counts_equal_jax(runs):
    """top-1/5 of the in-run val over all six images (a full batch and a
    padded tail of 2), recounted from the port's final weights. The
    packages' logits differ by up to d; a row may count otherwise in the
    two only where its label's logit is within 2 d of the k-th largest of
    the other classes' logits."""
    (_, jhist), (_, phist) = runs["jax"], runs["port"]
    port, ref, label = _val_logits(runs)
    d = np.abs(port - ref).max()
    assert d < 1e-3, d
    for k, key in ((1, "val_acc1"), (5, "val_acc5")):
        want = np.mean([(np.argsort(-row, kind="stable")[:k] == y).any() for row, y in zip(port, label)])
        assert phist[key] == [want]
        rival = [np.sort(np.delete(row, y))[::-1][k - 1] for row, y in zip(port, label)]
        near = [abs(row[y] - r) <= 2 * d for row, y, r in zip(port, label, rival)]
        if not any(near):
            assert phist[key] == jhist[key], key


def test_checkpoint_names_match_jax(runs):
    """ckpt_1 (the last epoch), best and backbone_best, as the JAX trainer
    writes them; best loads as a classifier and backbone_best as a
    backbone."""
    jdir, pdir = runs["work"] / "jax" / "parity", runs["work"] / "port" / "parity"
    names = lambda d: sorted(p.name for p in d.iterdir() if p.name.startswith(("ckpt_", "backbone")))  # noqa: E731
    assert names(pdir) == names(jdir) == ["backbone_best", "ckpt_1", "ckpt_1.meta.json",
                                          "ckpt_best", "ckpt_best.meta.json"]
    pstate, phist = runs["port"]
    meta = json.loads((pdir / "ckpt_best.meta.json").read_text())
    assert meta == {"epoch": 0, "acc1": phist["val_acc1"][0]}
    best = load_pretrained(str(pdir / "ckpt_best"), runs["pcfg"].model, kind="classifier")
    for k, v in pstate.model.state_dict().items():
        assert torch.equal(best[k], v), k
    backbone = load_pretrained(str(pdir / "backbone_best"), runs["pcfg"].model, kind="backbone")
    assert set(backbone) == {k for k in best if k.startswith("backbone.")}
    saved = CheckpointManager(pdir).restore(1)
    assert saved["step"] == 2 and set(saved) >= {"model", "optimizer", "generator", "mixup"}


def test_preempted_run_resumes_to_the_uninterrupted_run(tmp_path, monkeypatch):
    """Mixup on and drop path 0.1: two epochs of two steps straight, against
    one preempted at step 2 (a SIGTERM notice; ckpt_1 is written, the loop
    stops) and resumed. The resumed run restores the weights, AdamW, the
    step, the dropout generator and the mixup sampler, so it ends equal."""
    _, pcfg = _cfgs(tmp_path, **{"model.backbone.drop_path_rate": 0.1})
    common = dict(epochs=2, mixup=True, steps_per_epoch=2, device="cpu")
    straight, hist = trainer_cls.train_classifier(replace(pcfg, work_dir=str(tmp_path / "a")),
                                                  **common)
    cfg_b = replace(pcfg, work_dir=str(tmp_path / "b"))
    with monkeypatch.context() as mp:
        mp.setattr(trainer_cls.PreemptionGuard, "should_checkpoint", lambda self, step: step == 2)
        cut, cut_hist = trainer_cls.train_classifier(cfg_b, **common)
    assert cut.step == 2 and cut_hist["val_acc1"] == []
    meta = json.loads((tmp_path / "b" / "parity" / "ckpt_1.meta.json").read_text())
    assert meta == {"epoch": 0, "preempted": True}
    resumed, rhist = trainer_cls.train_classifier(cfg_b, resume=True, **common)
    assert resumed.step == straight.step == 4
    assert rhist["train_loss"] == hist["train_loss"][1:]
    for (k, v), w in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert resumed.mixup.get_state() == straight.mixup.get_state()
    assert torch.equal(resumed.generator.get_state(), straight.generator.get_state())
