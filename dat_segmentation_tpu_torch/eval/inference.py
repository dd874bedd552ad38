"""Segmentation inference: whole-image, sliding-window and multi-scale +
flip test-time augmentation, in PyTorch.

Counterpart of ``dat_segmentation_tpu/eval/inference.py:SegInferencer``
(the mmseg test path: per image, resize keeping the ratio to each TTA
scale, run whole or slide inference, resize the logits back to the
original size, softmax, average over scales and flips). By default
(``bucket=1``) every image runs at its true shape: the JAX package's exact
unpadded setting, which its exact padded inference is proven equal to.
``bucket`` > 1 pads whole-mode inputs to multiples of it, so that images of
mixed true shapes share one batch (``eval/evaluate.py``), with the JAX
meanings (``inference.py:121-135`` there): ``exact=True`` runs the exact
padded forward (``EncoderDecoder.forward(valid_hw=...)``,
``ops/valid_extent.py``) and slices the stride-4 logits to each image's
true stride-4 extent before resizing them to its true size, equal to the
true-shape forward; ``exact=False`` is the JAX plain zero-pad path, the
padded forward's logits resized to the padded size and then sliced. Slide
mode forwards partial windows at their true extent, what the JAX exact
path equals, whatever ``bucket`` and ``exact`` say. The JAX package's
``transfer_dtype`` (the device-to-host
copy) has no counterpart. The forward runs on the device in
``compute_dtype`` (bf16 on the card); everything after it (the bilinear resizes, the softmax, the
averaging, the argmax) runs there too, in float32, as PyTorch ops. The
logits' resizes are ``F.interpolate(mode='bilinear', align_corners=False,
antialias=False)``, cv2's ``INTER_LINEAR`` on float data; the raw uint8
image's test-time resizes are cv2's fixed-point ``INTER_LINEAR`` in integer
PyTorch ops (``ops/interpolate.py:resize_uint8_linear``), so the augmented
inputs equal the JAX package's, bit for bit.

On the card ``forward_batch`` replays a repeated input from a CUDA graph
(``ForwardGraphs``): the host enqueues one graph launch in place of the
forward's some 1,300 operations, with the same kernels and the same
arithmetic.
"""

from __future__ import annotations

import copy
import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Hashable, Iterator, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..data.ade20k import IMG_NORM_MEAN, IMG_NORM_STD, IMG_SCALE
from ..ops.interpolate import resize_bilinear, resize_uint8_linear
from ..ops.valid_extent import stride4_extent
from ..parallel import mesh
from ..utils import profiling
from ..utils.device import resolve_device

MS_RATIOS = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)  # tools/test.py --aug-test
# The graphs an inferencer holds at most: a server repeats a few batch
# shapes, an eval pass captures each shape (or bucket) it sees twice. The
# cap bounds the captures' one-off time and the static buffers they keep
# (PERF.md §6); a shape new to a full cache stays eager.
MAX_GRAPHS = 8

Image = Union[np.ndarray, torch.Tensor]


def round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of one (H, W, C) image (half-pixel centres)."""
    return resize_bilinear(x[None], tuple(out_hw))[0]


def graphable(device: torch.device, model: nn.Module) -> bool:
    """Whether ``model``'s forward on ``device`` may be captured: on a CUDA
    device, and not for a model split over a mesh axis, whose forward runs
    collectives. The second is a guard only: the trainer's validation and
    ``tools/test.py`` hand the inferencer a whole model."""
    return device.type == "cuda" and not mesh.is_split(model)


class ForwardGraphs:
    """Which forwards replay from a CUDA graph, by key (``forward_batch``:
    the input's shape, whether the forward is exact, the model's identity).

    A key's first sighting runs eagerly (it also builds the kernels and
    warms the libraries), its second is captured, later ones replay. Once
    ``MAX_GRAPHS`` graphs are held a new key stays eager: no graph is
    evicted, so none is captured twice. ``routes`` counts the calls by
    route."""

    def __init__(self):
        self.seen: Set[Hashable] = set()
        self.graphs: Dict[Hashable, object] = {}
        self.routes: Counter = Counter()

    def route(self, key: Hashable) -> str:
        """'replay', 'capture' or 'eager' for a call with ``key``."""
        if key in self.graphs:
            got = "replay"
        elif len(self.graphs) >= MAX_GRAPHS:
            got = "eager"
        elif key in self.seen:
            got = "capture"
        else:
            self.seen.add(key)
            got = "eager"
        self.routes[got] += 1
        return got


@dataclass
class _Captured:
    """One captured forward: its static input (and ``valid_hw``) and output
    buffers, the program counters its capture counted, and the model whose
    parameters' addresses the graph holds (kept alive with it)."""

    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    valid: Optional[torch.Tensor]
    out: torch.Tensor
    counts: Counter
    model: nn.Module


class SegInferencer:
    """Serve a segmentor: images in, logits or class maps out.

    ``model`` (an ``EncoderDecoder`` with its weights) is left as it is:
    the inferencer runs a copy, moved to ``device`` and cast to
    ``compute_dtype`` (as the JAX one casts a copy of the variables), so a
    trainer's float32 master weights survive a validation pass. ``mode`` is
    ``'whole'`` or ``'slide'`` (mmseg's test_cfg); slide mode runs
    ``crop_size`` (W, H) windows at ``stride`` (W, H), ``slide_batch``
    windows a forward. ``bucket``: the whole-mode pad-to multiple (1: each
    image at its true shape); ``exact``: the whole-mode padded forward is
    the exact one (else the plain zero-pad forward), as the JAX
    inferencer's.
    """

    def __init__(
        self,
        model: nn.Module,
        *,
        num_classes: int = 150,
        mode: str = "whole",
        crop_size: Tuple[int, int] = (512, 512),
        stride: Tuple[int, int] = (341, 341),
        compute_dtype: torch.dtype = torch.bfloat16,
        align_corners: bool = False,
        slide_batch: int = 4,
        bucket: int = 1,
        exact: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if mode not in ("whole", "slide"):
            raise ValueError(f"mode {mode!r}: 'whole' or 'slide'")
        if int(bucket) < 1:
            raise ValueError(f"bucket {bucket}: a pad-to multiple of 1 or more")
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model).to(device=self.device, dtype=compute_dtype).eval()
        self.num_classes = num_classes
        self.mode = mode
        self.crop_size = tuple(crop_size)
        self.stride = tuple(stride)
        self.compute_dtype = compute_dtype
        self.align_corners = align_corners
        self.slide_batch = max(int(slide_batch), 1)
        self.bucket = int(bucket)
        self.exact = bool(exact)
        bb = getattr(model, "backbone", None)
        self._conv_stem = bool(getattr(bb, "use_conv_patches", False))
        self._patch_size = int(getattr(bb, "patch_size", 4))
        self._mean = torch.tensor(IMG_NORM_MEAN, device=self.device)
        self._std = torch.tensor(IMG_NORM_STD, device=self.device)
        self._graphs = ForwardGraphs()
        self._pool = None  # the graphs' one memory pool: they replay one at a time

    def _image(self, img: Image) -> torch.Tensor:
        return torch.as_tensor(img).to(self.device, torch.float32)

    def _up(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        return resize_bilinear(x, tuple(out_hw), align_corners=self.align_corners)

    # -- forwards -----------------------------------------------------------

    def _ext4(self, hw):
        """The stride-4 logits' true extent of a true image size."""
        return tuple(int(v) for v in stride4_extent(hw, self._conv_stem, self._patch_size))

    @torch.inference_mode()
    def forward_batch(self, images: Image, valid_hw=None) -> torch.Tensor:
        """(B, H, W, 3) normalised float32, any H and W -> (B, h4, w4, C)
        float32 stride-4 logits, on the device. ``valid_hw`` ((B, 2) true
        sizes of zero-padded images) with ``exact``: the exact padded
        forward, whose rows and columns beyond each sample's stride-4
        extent (``_ext4``) are invalid; else the plain forward.

        On a CUDA device a repeated input shape (with its exactness, for
        this model) is replayed from a CUDA graph captured at its second
        sighting (``ForwardGraphs``); every call returns a fresh tensor,
        which later calls leave as it is."""
        with profiling.span("dat.serve"):
            x = torch.as_tensor(images)
            valid = None
            if valid_hw is not None and self.exact:
                valid = torch.as_tensor(np.asarray(valid_hw), dtype=torch.int32)
            route, key = "eager", None
            if graphable(self.device, self.model):
                key = (tuple(x.shape), valid is not None, id(self.model))
                route = self._graphs.route(key)
            if route == "eager":
                x = x.to(self.device, self.compute_dtype, non_blocking=True)
                return self._forward(x, None if valid is None else valid.to(self.device)).float()
            if route == "capture":
                self._graphs.graphs[key] = self._capture(x, valid)
            return self._replay(self._graphs.graphs[key], x, valid)

    def _forward(self, x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
        """The model's stride-4 logits in the compute dtype: exact where
        ``valid`` (the (B, 2) true sizes on the device) is given."""
        if valid is None:
            return self.model(x, upsample=False)
        return self.model(x, upsample=False, valid_hw=valid)

    def _capture(self, x: torch.Tensor, valid: Optional[torch.Tensor]) -> _Captured:
        """Capture the forward of static buffers shaped as ``x`` (and
        ``valid``), in the inferencer's one pool. The capture runs the
        forward's Python once and launches nothing: its program counters
        (``attn.composite``) are kept for each replay to count again. The
        kernels' ``.launches`` count their wrappers' calls, the capture's
        among them; a replay launches its kernels without them."""
        sx = torch.empty(x.shape, dtype=self.compute_dtype, device=self.device)
        sv = None if valid is None else valid.to(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with profiling.tally() as counts, torch.cuda.graph(
                graph, pool=self._pool, capture_error_mode="thread_local"):
            out = self._forward(sx, sv)
        return _Captured(graph, sx, sv, out, counts, self.model)

    @staticmethod
    def _replay(g: _Captured, x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
        """Copy the request into ``g``'s static buffers (the cast to the
        compute dtype is this copy), replay it and copy its logits out as
        float32, so that the next replay cannot overwrite what this call
        returns."""
        g.x.copy_(x, non_blocking=True)
        if valid is not None:
            g.valid.copy_(valid)
        g.graph.replay()
        for name, n in g.counts.items():
            profiling.count(name, n)
        profiling.count("serve.graph")
        return g.out.to(torch.float32, copy=True)  # a copy also where the compute is float32

    def _padded(self, imgs: Sequence[torch.Tensor], hw, batch: Optional[int] = None):
        """Images zero-padded to ``hw`` in a batch of ``batch`` (the empty
        slots zeros of the full extent), and their (B, 2) true sizes."""
        n = batch or len(imgs)
        x = torch.zeros(n, hw[0], hw[1], 3, device=self.device)
        valid = np.full((n, 2), hw, np.int32)
        for i, im in enumerate(imgs):
            x[i, :im.shape[0], :im.shape[1]] = im
            valid[i] = im.shape[:2]
        return x, valid

    def _bucket_logits(self, small: torch.Tensor, hw, bucket_hw, exact: bool) -> torch.Tensor:
        """One image's (h, w, C) logits from its padded forward's stride-4
        logits: sliced to the true stride-4 extent and resized to (h, w)
        (exact; mmseg resizes the exact run's logits to the image), or
        resized to the padded size and sliced (the plain path)."""
        if exact:
            eh, ew = self._ext4(hw)
            return _resize(small[:eh, :ew], hw)
        return _resize(small, bucket_hw)[:hw[0], :hw[1]]

    @torch.inference_mode()
    def _whole(self, img: torch.Tensor) -> torch.Tensor:
        h, w = img.shape[:2]
        hb, wb = round_up(h, self.bucket), round_up(w, self.bucket)
        if (hb, wb) == (h, w):
            small = self.forward_batch(img[None])
            return self._up(small, (h, w))[0]
        x, valid = self._padded([img], (hb, wb))
        small = self.forward_batch(x, valid_hw=valid)
        return self._bucket_logits(small[0], (h, w), (hb, wb), self.exact)

    @torch.inference_mode()
    def _slide(self, img: torch.Tensor) -> torch.Tensor:
        """mmseg slide mode: crops at ``stride``, averaged where they
        overlap. Windows start at min(r * stride, padded size - crop), the
        image padded up to one crop. Where the image is smaller than the
        crop a window is forwarded at the image's true extent, as mmseg
        forwards it; windows of one extent run batched."""
        h, w = img.shape[:2]
        cw, ch = self.crop_size
        sw, sh = self.stride
        hp, wp = max(h, ch), max(w, cw)
        rows = max(math.ceil((hp - ch) / sh) + 1, 1)
        cols = max(math.ceil((wp - cw) / sw) + 1, 1)
        groups = {}
        for r in range(rows):
            for c in range(cols):
                y1, x1 = min(r * sh, hp - ch), min(c * sw, wp - cw)
                groups.setdefault((min(h - y1, ch), min(w - x1, cw)), []).append((y1, x1))
        total = torch.zeros(hp, wp, self.num_classes, device=self.device)
        count = torch.zeros(hp, wp, 1, device=self.device)
        for (vh, vw), wins in groups.items():
            for lo in range(0, len(wins), self.slide_batch):
                chunk = wins[lo : lo + self.slide_batch]
                crops = torch.stack([img[y1 : y1 + vh, x1 : x1 + vw] for y1, x1 in chunk])
                out = self._up(self.forward_batch(crops), (vh, vw))
                for (y1, x1), o in zip(chunk, out):
                    total[y1 : y1 + vh, x1 : x1 + vw] += o
                    count[y1 : y1 + vh, x1 : x1 + vw] += 1.0
        return (total / count.clamp_min(1.0))[:h, :w]

    def _logits(self, img: torch.Tensor) -> torch.Tensor:
        return self._slide(img) if self.mode == "slide" else self._whole(img)

    def logits_whole(self, img: Image) -> np.ndarray:
        """img (H, W, 3) normalised float32 -> (H, W, C) float32 logits."""
        return self._whole(self._image(img)).cpu().numpy()

    def logits_slide(self, img: Image) -> np.ndarray:
        """Slide-mode (H, W, C) float32 logits of a normalised image."""
        return self._slide(self._image(img)).cpu().numpy()

    def logits(self, img: Image) -> np.ndarray:
        """(H, W, C) float32 logits in this inferencer's mode."""
        return self._logits(self._image(img)).cpu().numpy()

    def _class_map(self, logits: torch.Tensor, ori) -> np.ndarray:
        """(h, w, C) logits -> (H_ori, W_ori) int32 class map on the host:
        resized to the original size, then the argmax (the softmax does
        not change it)."""
        if tuple(logits.shape[:2]) != tuple(ori):
            logits = _resize(logits, ori)
        return logits.argmax(-1).to(torch.int32).cpu().numpy()

    @torch.inference_mode()
    def _predict_whole_batch(self, inputs: Sequence[torch.Tensor], ori_shapes) -> list:
        """Whole-mode single-scale class maps of normalised inputs of one
        shape, in one forward: each as ``predict`` makes it."""
        small = self.forward_batch(torch.stack(list(inputs)))
        logits = self._up(small, inputs[0].shape[:2])
        return [self._class_map(lg, ori) for lg, ori in zip(logits, ori_shapes)]

    # -- test-time augmentation ------------------------------------------------

    @torch.inference_mode()
    def tta_inputs(
        self,
        raw_img: Image,
        *,
        img_scale: Tuple[int, int] = IMG_SCALE,
        ratios: Sequence[float] = (1.0,),
        flip: bool = False,
        keep_ratio: bool = True,
    ) -> Iterator[Tuple[torch.Tensor, bool]]:
        """Yield (normalised (h, w, 3) float32 image on the device, flipped)
        for every TTA variant of a raw RGB uint8 image (mmseg
        MultiScaleFlipAug: ``img_scale`` (W, H) times each ratio, keeping
        the aspect ratio; each resize cv2's uint8 ``INTER_LINEAR``, bit for
        bit)."""
        raw = torch.as_tensor(raw_img).to(self.device)
        h, w = raw.shape[:2]
        for ratio in ratios:
            tw, th = int(img_scale[0] * ratio), int(img_scale[1] * ratio)
            if keep_ratio:
                f = min(tw / w, th / h)
                rw, rh = int(w * f + 0.5), int(h * f + 0.5)
            else:
                rw, rh = tw, th
            resized = resize_uint8_linear(raw, (rh, rw)).float()
            norm = (resized - self._mean) / self._std
            for do_flip in ((False, True) if flip else (False,)):
                yield (torch.flip(norm, dims=[1]) if do_flip else norm), do_flip

    @torch.inference_mode()
    def predict(
        self,
        raw_img: Image,
        *,
        img_scale: Tuple[int, int] = IMG_SCALE,
        ratios: Sequence[float] = (1.0,),
        flip: bool = False,
        keep_ratio: bool = True,
        ori_shape: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """The test pipeline on a raw RGB uint8 image: (H_ori, W_ori) int32
        class map.

        One scale without flip: the argmax of the logits resized to the
        original size (the softmax does not change it). Otherwise, per
        variant, the logits (flipped back) are resized to the original size
        and then soft-maxed, as mmseg orders it, and the probabilities are
        averaged. Ties go to the lowest class index.
        """
        ori = tuple(ori_shape or raw_img.shape[:2])
        variants = self.tta_inputs(raw_img, img_scale=img_scale, ratios=ratios, flip=flip,
                                   keep_ratio=keep_ratio)
        if len(ratios) == 1 and not flip:
            (inp, _), = variants
            return self._class_map(self._logits(inp), ori)
        prob_sum = torch.zeros(*ori, self.num_classes, device=self.device)
        n = 0
        for inp, do_flip in variants:
            logits = self._logits(inp)
            if do_flip:
                logits = torch.flip(logits, dims=[1])
            if tuple(logits.shape[:2]) != ori:
                logits = _resize(logits, ori)
            prob_sum += torch.softmax(logits, dim=-1)
            n += 1
        return (prob_sum / n).argmax(-1).to(torch.int32).cpu().numpy()
