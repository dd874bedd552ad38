"""The port's ADE20K val path against the JAX package's, on the CPU.

On the committed fixture ``tests/data/ade20k_tiny`` (six images at ADE20K
shapes, masks labelled 0-150; ``tests/data/make_ade20k_tiny.py``):
dataset discovery in both layouts, ``load_raw`` (the port decodes without
cv2), the val transform, the PNG reader, and ``evaluate_dataset`` whole,
with test-time augmentation, sharded and batched, against the JAX
``evaluate_dataset`` with ``SegInferencer(exact=True)``, float32 on both
sides, and the bucket-batched ``evaluate_dataset`` (bucket 32, batch 2:
whole, with TTA, and on the plain zero-pad path) against the JAX one at
the same settings. One small SemanticFPN (150 classes) is built in both
packages from one preset, its JAX variables drawn from a numpy seed and
carried across.

Class maps are equal except at argmax near-ties: both sides' logits agree
within 1e-4 (``test_torch_eval.py``), so a pixel may flip only where the
top two logits (single scale) are within 2e-4 of each other, or the top
two averaged probabilities (TTA) within 1e-5. Such pixels must stay
under 1e-4 of all; the per-class counts then differ by at most one a
flipped pixel in ``inter`` and two in ``union``.

Whole mode runs at ``img_scale=(128, 64)``. TTA runs at (256, 128) on the
first two images (both 512x512, one shape, so the JAX package compiles
one program a ratio): at (128, 64) the 0.5 ratio gives 32-pixel sides,
whose stage-3 grid is 1 wide, where the reference grid divides by zero.
"""

import dataclasses
import hashlib
import json
import shutil
import struct
import zlib
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dat_segmentation_tpu.configs import get_config as jax_get_config
from dat_segmentation_tpu.data.ade20k import ADE20KDataset as JaxADE20KDataset
from dat_segmentation_tpu.eval.evaluate import evaluate_dataset as jax_evaluate_dataset
from dat_segmentation_tpu.eval.inference import (
    SegInferencer as JaxSegInferencer, _np_softmax, _resize_probs)
from dat_segmentation_tpu.models import build_model as jax_build_model
from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
from dat_segmentation_tpu_torch.data.image_io import imread_gray, imread_rgb, read_png_gray8
from dat_segmentation_tpu_torch.eval.evaluate import evaluate_dataset, merge_shard_results
from dat_segmentation_tpu_torch.tools import test as test_cli
from dat_segmentation_tpu_torch.tools.reference_schema import save_reference
from torch_port_helpers import carry, random_variables, small_fpn

ROOT = Path(__file__).resolve().parent / "data" / "ade20k_tiny"
DIGESTS = json.loads((ROOT / "cv2_digests.json").read_text())
SCALE, TTA_SCALE = (128, 64), (256, 128)
LOGIT_TIE = 2e-4  # twice the logits' agreement (1e-4)
PROB_TIE = 1e-5
MAX_FLIPPED = 1e-4  # share of all pixels


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(small_fpn(jax_get_config, num_classes=150))
    variables = random_variables(jmodel, np.zeros((1, 64, 64, 3), np.float32), seed=5,
                                 train=False)
    jinf = JaxSegInferencer(jmodel, variables, num_classes=150, exact=True,
                            compute_dtype=jnp.float32, transfer_dtype=jnp.float32)
    torch.manual_seed(0)
    pmodel = carry(build_model(small_fpn(get_config, num_classes=150), device="cpu"), variables)
    pinf = SegInferencer(pmodel, num_classes=150, compute_dtype=torch.float32, device="cpu")
    return jinf, pinf, pmodel


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _collect(preds):
    return lambda idx, pred: preds.__setitem__(idx, pred)


def _check_counts(got, ref, flipped, total):
    assert got["num_images"] == ref["num_images"]
    assert flipped <= MAX_FLIPPED * total, (flipped, total)
    d_inter = np.abs(np.subtract(got["inter"], ref["inter"])).sum()
    d_union = np.abs(np.subtract(got["union"], ref["union"])).sum()
    assert d_inter <= flipped and d_union <= 2 * flipped, (d_inter, d_union, flipped)


def _top2_gap(a):
    top2 = np.sort(a, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# -- data -------------------------------------------------------------------


def _alt_layout(tmp_path):
    root = tmp_path / "alt"
    shutil.copytree(ROOT / "images" / "validation", root / "val" / "img")
    shutil.copytree(ROOT / "annotations" / "validation", root / "val" / "annotations")
    return root


@pytest.mark.parametrize("layout", ["images_annotations", "split_img"])
def test_dataset_discovers_both_layouts_as_jax(layout, tmp_path):
    root = ROOT if layout == "images_annotations" else _alt_layout(tmp_path)
    got, ref = ADE20KDataset(root, "val"), JaxADE20KDataset(root, "val")
    assert len(got) == len(ref) == 6
    assert got.images == ref.images and got.masks == ref.masks


def test_dataset_refuses_what_it_lacks(tmp_path):
    with pytest.raises(FileNotFoundError, match="ADE20K layout not found"):
        ADE20KDataset(tmp_path, "val")
    train = tmp_path / "images" / "training"
    train.mkdir(parents=True)
    (tmp_path / "annotations" / "training").mkdir(parents=True)
    shutil.copy(sorted((ROOT / "images" / "validation").glob("*.jpg"))[0], train / "a.jpg")
    with pytest.raises(FileNotFoundError):  # an image without its mask
        ADE20KDataset(tmp_path, "train")[0]


def test_load_raw_equals_jax():
    """Masks after reduce_zero_label, and the images (Pillow here, cv2 in
    the JAX package), bit for bit."""
    got, ref = ADE20KDataset(ROOT, "val"), JaxADE20KDataset(ROOT, "val")
    for i in range(len(ref)):
        (gi, gm), (ri, rm) = got.load_raw(i), ref.load_raw(i)
        assert gi.dtype == ri.dtype == np.uint8 and gm.dtype == rm.dtype == np.int32
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gm, rm)
        assert set(np.unique(gm)) >= {255}  # label 0 is in every mask: the ignore index


@pytest.mark.parametrize("keep_ratio", [False, True])
def test_val_item_equals_jax(keep_ratio):
    got = ADE20KDataset(ROOT, "val", keep_ratio_val=keep_ratio)
    ref = JaxADE20KDataset(ROOT, "val", keep_ratio_val=keep_ratio)
    for i in (2, 4):  # 512x683 and 384x512: padded to the crop when the ratio is kept
        g, r = got[i], ref[i]
        assert g["path"] == r["path"]
        assert g["image"].dtype == r["image"].dtype == np.float32
        np.testing.assert_array_equal(g["image"], r["image"])
        np.testing.assert_array_equal(g["label"], r["label"])


def test_readers_equal_cv2_on_the_fixture():
    for name, d in DIGESTS["masks"].items():
        path = ROOT / "annotations" / "validation" / name
        mask = imread_gray(path)
        np.testing.assert_array_equal(mask, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
        assert _sha(mask) == d["sha256"] and list(mask.shape) == d["shape"]
    for name, d in DIGESTS["images"].items():
        img = imread_rgb(ROOT / "images" / "validation" / name)
        assert _sha(img) == d["sha256"] and list(img.shape) == d["shape"]
    for path in sorted((ROOT / "decode").glob("*.jpg")):
        np.testing.assert_array_equal(imread_rgb(path), np.load(path.with_suffix(".npz"))["rgb"])


def _png(img, filters, colour=0):
    """An 8-bit PNG whose row y is written with filters[y % len(filters)]."""
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    h, w = img.shape[:2]
    flat = img.reshape(h, -1).astype(np.int32)
    raw, prev = bytearray(), np.zeros(flat.shape[1], np.int32)
    for y in range(h):
        f, cur = filters[y % len(filters)], flat[y]
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][f]
        raw.append(f)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    head = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def test_png_reader_takes_every_row_filter():
    """cv2 writes every row with the Sub filter; other writers choose per
    row. Rows in turn with None, Sub, Up, Average and Paeth."""
    img = np.random.RandomState(3).randint(0, 256, (41, 57)).astype(np.uint8)
    data = _png(img, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8),
                                               cv2.IMREAD_GRAYSCALE), img)
    np.testing.assert_array_equal(read_png_gray8(data), img)


def test_png_reader_refuses_other_kinds():
    rgb = np.random.RandomState(4).randint(0, 256, (8, 9, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".png", rgb)
    with pytest.raises(ValueError, match="8-bit RGB PNG"):
        read_png_gray8(buf.tobytes())
    ok, buf = cv2.imencode(".png", rgb[..., 0].astype(np.uint16) * 200)
    with pytest.raises(ValueError, match="16-bit greyscale PNG"):
        read_png_gray8(buf.tobytes())
    with pytest.raises(ValueError, match="CRC"):
        data = bytearray(_png(rgb[..., 0], [1]))
        data[-20] ^= 1  # inside the IDAT chunk
        read_png_gray8(bytes(data))


# -- evaluate_dataset -------------------------------------------------------


def _jax_logit_gaps(jinf, raw, ori, scale):
    (inp, _), = jinf.tta_inputs(raw, img_scale=scale)
    return _top2_gap(_resize_probs(jinf.logits(inp), ori))


def test_evaluate_whole_matches_jax(pair):
    jinf, pinf, _ = pair
    jax_preds, preds = {}, {}
    ref = jax_evaluate_dataset(jinf, JaxADE20KDataset(ROOT, "val"), img_scale=SCALE,
                               verbose=False, on_pred=_collect(jax_preds))
    got = evaluate_dataset(pinf, ADE20KDataset(ROOT, "val"), img_scale=SCALE, verbose=False,
                           on_pred=_collect(preds))
    assert sorted(preds) == sorted(jax_preds) == list(range(6))
    assert set(got) == set(ref)
    ds, flipped, total = ADE20KDataset(ROOT, "val"), 0, 0
    for i, pred in preds.items():
        assert pred.dtype == np.int32 and pred.shape == jax_preds[i].shape
        differ = pred != jax_preds[i]
        if differ.any():
            raw, gt = ds.load_raw(i)
            gaps = _jax_logit_gaps(jinf, raw, gt.shape, SCALE)
            assert (gaps[differ] <= LOGIT_TIE).all(), gaps[differ].max()
        flipped, total = flipped + int(differ.sum()), total + pred.size
    _check_counts(got, ref, flipped, total)
    assert all(isinstance(v, int) for v in got["inter"] + got["union"])
    assert got["mIoU"] == pytest.approx(ref["mIoU"], abs=1e-3)


def test_evaluate_aug_test_matches_jax(pair, monkeypatch):
    """MS_RATIOS with flip on the first two images. Both sides see the JAX
    TTA inputs (the port's own are held to them bit for bit in
    test_torch_eval.py), so that what is compared is the rest."""
    jinf, pinf, _ = pair

    def jax_inputs(raw_img, **kw):
        for inp, do_flip in jinf.tta_inputs(raw_img, **kw):
            yield torch.from_numpy(inp.copy()), do_flip

    monkeypatch.setattr(pinf, "tta_inputs", jax_inputs)
    jax_preds, preds = {}, {}
    kw = dict(img_scale=TTA_SCALE, aug_test=True, max_images=2, verbose=False)
    ref = jax_evaluate_dataset(jinf, JaxADE20KDataset(ROOT, "val"), on_pred=_collect(jax_preds),
                               **kw)
    got = evaluate_dataset(pinf, ADE20KDataset(ROOT, "val"), on_pred=_collect(preds), **kw)
    assert got["num_images"] == 2 and sorted(preds) == [0, 1]
    ds, flipped, total = ADE20KDataset(ROOT, "val"), 0, 0
    for i, pred in preds.items():
        differ = pred != jax_preds[i]
        if differ.any():
            raw, gt = ds.load_raw(i)
            acc = 0.0
            for inp, do_flip in jinf.tta_inputs(raw, img_scale=TTA_SCALE,
                                                ratios=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75), flip=True):
                logits = jinf.logits(inp)
                logits = logits[:, ::-1] if do_flip else logits
                acc = acc + _np_softmax(_resize_probs(logits, gt.shape))
            assert (_top2_gap(acc / 12)[differ] <= PROB_TIE).all()
        flipped, total = flipped + int(differ.sum()), total + pred.size
    _check_counts(got, ref, flipped, total)


def test_shards_merge_to_the_whole(pair):
    _, pinf, _ = pair
    kw = dict(img_scale=SCALE, verbose=False)
    whole = evaluate_dataset(pinf, ADE20KDataset(ROOT, "val"), **kw)
    shards = [evaluate_dataset(pinf, ADE20KDataset(ROOT, "val"), shard_info=(r, 2), **kw)
              for r in (0, 1)]
    assert [s["num_images"] for s in shards] == [3, 3]
    merged = merge_shard_results(shards, num_classes=150)
    assert merged["num_images"] == 6
    assert merged["mIoU"] == whole["mIoU"]
    assert merged["per_class_iou"] == whole["per_class_iou"]
    np.testing.assert_array_equal(np.add(shards[0]["inter"], shards[1]["inter"]), whole["inter"])


def test_batched_eval_equals_per_image(pair):
    """batch_size 4 puts the two 512x512 images into one forward (the
    others have shapes of their own); near-ties as above, on the port's
    own per-image logits."""
    _, pinf, _ = pair
    single, batched = {}, {}
    kw = dict(img_scale=SCALE, verbose=False)
    ref = evaluate_dataset(pinf, ADE20KDataset(ROOT, "val"), on_pred=_collect(single), **kw)
    calls = []
    forward = pinf.forward_batch
    pinf.forward_batch = lambda x: calls.append(tuple(x.shape)) or forward(x)
    try:
        got = evaluate_dataset(pinf, ADE20KDataset(ROOT, "val"), batch_size=4,
                               on_pred=_collect(batched), **kw)
    finally:
        del pinf.forward_batch
    assert calls[0][0] == 2 and len(calls) == 5
    ds, flipped, total = ADE20KDataset(ROOT, "val"), 0, 0
    for i, pred in single.items():
        differ = pred != batched[i]
        if differ.any():
            raw, gt = ds.load_raw(i)
            (inp, _), = pinf.tta_inputs(raw, img_scale=SCALE)
            logits = torch.from_numpy(pinf.logits(inp))[None]
            gaps = _top2_gap(torch.nn.functional.interpolate(
                logits.permute(0, 3, 1, 2), size=gt.shape, mode="bilinear",
                align_corners=False).permute(0, 2, 3, 1)[0].numpy())
            assert (gaps[differ] <= LOGIT_TIE).all()
        flipped, total = flipped + int(differ.sum()), total + pred.size
    _check_counts(got, ref, flipped, total)


@pytest.mark.parametrize("run", ["whole", "aug_test", "no_exact"])
def test_bucketed_evaluate_matches_jax(pair, run, monkeypatch):
    """``evaluate_dataset(batch_size=2)`` with both inferencers at bucket 32
    (the JAX one's default): the bucket batcher on both sides. ``whole``:
    the six images at (128, 64), in 64x64 and 64x96 buckets, each holding
    partial inputs, through the exact padded forward; ``aug_test``: MS_RATIOS
    with flip on image 2 alone (512x683; shard (2, 4)), whose inputs fill
    four partial buckets and two full ones; ``no_exact``: ``whole`` on the
    plain zero-pad path of both packages. Class maps as above (the TTA
    inputs the JAX ones, as in the aug_test test); near-ties on the JAX
    inferencer's own logits in that setting."""
    jinf, pinf, _ = pair
    exact = run != "no_exact"
    assert jinf.bucket == 32
    monkeypatch.setattr(jinf, "exact", exact)
    monkeypatch.setattr(pinf, "exact", exact)
    monkeypatch.setattr(pinf, "bucket", 32)
    calls = []
    forward = pinf.forward_batch
    monkeypatch.setattr(pinf, "forward_batch", lambda x, valid_hw=None: calls.append(
        (tuple(x.shape), valid_hw is not None)) or forward(x, valid_hw))
    aug = run == "aug_test"
    if aug:
        def jax_inputs(raw_img, **kw):
            for inp, do_flip in jinf.tta_inputs(raw_img, **kw):
                yield torch.from_numpy(inp.copy()), do_flip

        monkeypatch.setattr(pinf, "tta_inputs", jax_inputs)
        kw = dict(img_scale=TTA_SCALE, aug_test=True, shard_info=(2, 4))
    else:
        kw = dict(img_scale=SCALE)
    jax_preds, preds = {}, {}
    ref = jax_evaluate_dataset(jinf, JaxADE20KDataset(ROOT, "val"), batch_size=2, verbose=False,
                               on_pred=_collect(jax_preds), **kw)
    got = evaluate_dataset(pinf, ADE20KDataset(ROOT, "val"), batch_size=2, verbose=False,
                           on_pred=_collect(preds), **kw)
    assert sorted(preds) == sorted(jax_preds) == ([2] if aug else list(range(6)))
    assert all(shape[0] == 2 for shape, _ in calls)
    assert any(v for _, v in calls) == exact  # valid_hw only where a bucket holds a partial input
    assert len(calls) == (6 if aug else 4)
    ds, flipped, total = ADE20KDataset(ROOT, "val"), 0, 0
    for i, pred in preds.items():
        differ = pred != jax_preds[i]
        if differ.any():
            raw, gt = ds.load_raw(i)
            if aug:
                acc = 0.0
                for inp, do_flip in jinf.tta_inputs(raw, img_scale=TTA_SCALE,
                                                    ratios=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
                                                    flip=True):
                    logits = jinf.logits(inp)
                    logits = logits[:, ::-1] if do_flip else logits
                    acc = acc + _np_softmax(_resize_probs(logits, gt.shape))
                assert (_top2_gap(acc / 12)[differ] <= PROB_TIE).all()
            else:
                gaps = _jax_logit_gaps(jinf, raw, gt.shape, SCALE)
                assert (gaps[differ] <= LOGIT_TIE).all(), gaps[differ].max()
        flipped, total = flipped + int(differ.sum()), total + pred.size
    _check_counts(got, ref, flipped, total)


def test_distributed_is_not_ported(pair):
    """``distributed=True`` outside a process group is the one-process
    evaluation, as the JAX package's is with one process (the reduction
    over processes is held in tests/test_torch_parallel.py)."""
    ds = ADE20KDataset(ROOT, "val")
    got = evaluate_dataset(pair[1], ds, distributed=True, max_images=2, verbose=False)
    want = evaluate_dataset(pair[1], ds, max_images=2, verbose=False)
    assert got["num_images"] == want["num_images"] == 2
    assert got["inter"] == want["inter"] and got["union"] == want["union"]


def test_cli_writes_the_result_dict(pair, tmp_path, monkeypatch, capsys):
    """The port's tools/test.py on a mmseg-schema .pth of the small model
    (its preset name resolved to the small config): the load report is
    empty and the result equals evaluate_dataset's on the same weights."""
    jinf, _, pmodel = pair
    cfg = get_config("fpn_tiny_80k_dp04_lr2")
    small = dataclasses.replace(cfg, model=small_fpn(get_config, num_classes=150),
                                data=dataclasses.replace(cfg.data, img_scale=SCALE))
    monkeypatch.setattr(test_cli, "load_config", lambda name: small)
    ckpt = save_reference(pmodel, small.model, tmp_path / "fpn_mmseg.pth")
    out = tmp_path / "r.json"
    res = test_cli.main(["fpn_tiny_80k_dp04_lr2", str(ckpt), "--data-root", str(ROOT),
                         "--max-images", "3", "--out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "tensors; missing 0, unexpected 0, mismatched 0" in text
    assert "mIoU:" in text and "Class" in text
    written = json.loads(out.read_text())
    assert written == json.loads(json.dumps(res))
    ref = jax_evaluate_dataset(jinf, JaxADE20KDataset(ROOT, "val"), img_scale=SCALE,
                               max_images=3, verbose=False)
    assert set(written) == set(ref) and written["num_images"] == 3
    direct = evaluate_dataset(SegInferencer(pmodel, num_classes=150, device="cpu"),
                              ADE20KDataset(ROOT, "val"), img_scale=SCALE, max_images=3,
                              batch_size=4, verbose=False)
    assert written["inter"] == direct["inter"] and written["union"] == direct["union"]
