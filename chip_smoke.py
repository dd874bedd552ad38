#!/usr/bin/env python3
"""Drive the PyTorch port's serving forward and training step, its eval and
trainer, and the classifier slice on one CUDA card and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a), the
CUDA toolkit's ``nvcc`` and the repository; it exits non-zero at once
without a CUDA device, and never runs on the CPU instead. Phases, one JSON
line each:

1. device: the card's name and power limit (as nvidia-smi gives them),
   the torch, CUDA and nvcc versions.
2. build: every CUDA source of the port, built at once (one nvcc each,
   the attribution variants of K1 and K2 beside them; K1's and K2's
   checks of phase 3 run while K3's nvcc, the longest, finishes), with the
   registers, spills and shared memory ptxas and the launchers report;
   K1's and K2's resident blocks and warps an SM at each stage's table
   (bf16 must reach 16 warps for K1, 8 for K2); K3's tile, shared memory,
   registers and resident blocks and warps an SM per (width, mode, dtype)
   (every width must have a tile that fits); the count of tensor-core
   instructions (HMMA/HGMMA) in each one's SASS (must be more than 0).
3. kernel_check: each kernel against its plain PyTorch version on the card
   at the shapes the main paths give it, in float32 and bf16 (K1: also
   its log-sum-exp, and its serving output bit for bit that of the launch
   that writes the log-sum-exp; K1 and K2 also with pos ~ U(-3, 3), taps
   wholly outside the table; K2: all five gradients, also at Ns 289, a
   544x544 crop's stage 0, and Ns 1064; K3: both modes at the four T++
   stage shapes, the four S++ widths, the four B++ widths in both modes,
   no LPU, a rectangular image, sides that are not tile multiples,
   windows 3, 5 and 9, each case twice and equal bit for bit).
4. model: the full-width, full-depth DAT-T++ SemanticFPN (preset
   fpn_tiny_80k_dp04_lr2, 26 blocks) at 512x512 with random weights from
   a fixed seed, in float32 with TF32 off: the kernel path on the card
   against the plain path (the same model on the CPU); then the same
   weights with ``kernel_impl='pallas'`` (K3 on), card against CPU and
   against the card's unfused run.
5. serve: the main path. ``SegInferencer`` answers requests in bf16
   (batches of 512x512 images, then one whole image), the repeated batch
   shape replayed from a CUDA graph from its second request on. Each
   kernel's launches are counted by name on the profiler's device track,
   which shows a replay's kernels: 14 K1 a forward; the kernels' wrappers
   (their ``.launches``, set to 0 just before) must count the forwards
   that ran the model's Python (eager and captured), and no replay.
   serve_pallas: the same with ``kernel_impl='pallas'`` (26 K3 and 14 K1
   launches a forward), then ``predict`` on a raw 512x683 uint8 image,
   single-scale in slide mode and multi-scale + flip in whole mode: each
   request's K3 count on the device track must equal the count the JAX
   package's gate gives for the sizes its forwards ran at. serve_small: DAT-S++ UperNet
   (``upn_small_160k``) with ``kernel_impl='pallas'``, one bf16 batch.
6. times: K1 per stage (beside its attribution build: no bias) and K3
   per (stage, mode) (CUDA events, after
   warm-up) beside its plain version, one PyTorch library call computing
   the same function (K3: none computes it, so the yardstick is the
   unfused stock-op chain the model runs without K3; used nowhere in the
   port) and the least time the card could take; the forward at batch 16
   in bf16 (ms/img, img/s, peak memory), with ``kernel_impl`` 'auto' and
   'pallas' in turns, and profiles of where their device time goes.
7. train_model (run after 4, before 5): the full-width, full-depth
   DAT-T++ UperNet with its FCN
   auxiliary head (preset upn_tiny_160k_dp03_lr6, 150 classes) from a
   fixed seed takes one float32 train step (TF32 off, drop path and
   dropout 0) on a 2x512x512 batch: the kernel path on the card against a
   copy of the same model on the CPU (loss, gradients, BN statistics, IoU
   counts); then again with ``kernel_impl='pallas'``.
8. train: the main path of the training slice. ``make_train_step`` on the
   preset as it is (drop path 0.3, dropout 0.1; warm-up 0 so the learning
   rate is not 6e-11) in bf16 at batch 16, a few steps on one synthetic
   batch; the launch counts, set to 0 just before, must show 14 K1 and 14
   K2 launches a step; then a few steps with ``kernel_impl='pallas'`` (26
   K3, 14 K1 and 14 K2 launches a step); train_crop: one step at a
   544x544 crop, batch 2 (Ns 289 at stage 0); train_checkpoint: a step
   with ``use_checkpoint=True`` at batch 16 (28 K1 and 14 K2 launches: the
   stages run again in the backward).
9. train times: K2 per stage as K1 above (the yardstick is the backward
   of one ``scaled_dot_product_attention`` with the bias prebuilt), beside
   its attribution build (no bias gradient); the train step at batch 16 (ms, img/s,
   peak memory) and a profile of its device time; the step with 'auto'
   and 'pallas' in turns; the step with ``use_checkpoint`` (ms, peak
   memory).
10. eval: ADE20K val to mIoU on the fixture ``tests/data/ade20k_tiny``
   (six images, masks labelled 0-150). decode: the port's readers against
   cv2's decodes stored there (masks bit for bit; the JPEG decoder's
   difference and share of differing pixels gated), with the decoder's
   name and ms an image. load: the flagship at full width and depth,
   random weights from the seed, written as a mmseg-schema ``.pth`` and
   read back through ``load_pretrained`` + ``merge_pretrained`` (empty
   report, every tensor equal). The port's test CLI
   (``tools/test.py:main``) in bf16 whole mode at the preset's
   ``img_scale``, batch 1 and batch 4 (counts set to 0 just before: 14 K1
   launches a forward; batch 4's counts within a stated share of batch
   1's; batch 1 also writes ``--show-dir`` and ``--format-dir`` PNGs, a
   pair an image at its size), and one image with ``--aug-test`` (12
   forwards). The float32 eval card against CPU, per pixel. img/s of the
   bf16 eval at batch 1 and 4 in turns, and the share of batch 1's wall
   time in decode, ``predict`` and the IoU update.
10c. exact_eval (run after 10, before 10b): exact padded inference
   (``ops/valid_extent.py``) and the bucket-batched eval. The flagship at full width and depth, random
   weights from the seed; four images of different true sizes in one
   512x704 bucket of 32. float32, TF32 off: the exact padded forward
   (``valid_hw``: the attention's composite, 0 K1 launches) against each
   image's true-shape forward (K1), gated at 1e-4 on the stride-4 logits;
   bf16: the pair's argmax agreement; the plain padded forward
   (``exact=False``): each of its 14 K1 launches (128x176 queries at stage
   0, Ns 352) against K1's plain version, float32 and bf16. The test CLI
   with ``--pad-bucket 32`` and with ``--no-exact`` on the fixture (counts
   set to 0 just before: K1 in the forwards whose inputs all fill their
   bucket, 14 each; the exact ones run the composite); the bucketed exact
   eval against the true-shape eval in bf16 at batch 4 (counts within the
   eval phase's share), img/s in turns and each one's device busy share,
   each inferencer's forwards by route (eager, captured, replayed), its
   graphs and its passes' peak memory;
   the exact forward's ms and device ms a batch beside the plain padded
   one's.
10b. export: the serving export (``serving/``). The flagship from the eval
   phase's ``.pth`` through ``tools/export.py --check`` (bf16, batch 16,
   entries 512x512 and 512x704, the artifact within 1e-3 relative of
   ``SegInferencer.forward_batch``), and with ``--no-portable`` on a
   ``'pallas'`` config (batch 1), each carrying its kernels' ``sm_90a``
   libraries; each served in two fresh processes, started as soon as it
   is written (beside the next export, the classifier's exports and the
   mesh phases' processes, 17b-17d), that import only
   ``dat_segmentation_tpu_torch.serving`` (no
   ``models`` module may be loaded there), each from a copy of the package
   without ``_build/``: once stripped of the libraries, so that the loader
   builds them with nvcc, and once as exported where nvcc cannot be found
   (``nvcc_path()`` must raise and nothing may be built; logits and class
   maps bit for bit the first run's): 14 K1 launches a forward, and 26 K3
   with 'pallas' (counts set to 0 just before), the logits against
   ``SegInferencer.forward_batch`` on the same input (equal bit for bit or
   not, reported), ``predict_semseg`` on the raw 512x683 image against the
   live model on the same padded input (gated) and the live whole mode
   (reported); the classifier (cls_tiny_imagenet, 224², batch 1 and 128)
   against the live ``DatClassifier``; the artifact's and the live model's
   ms a batch of 16 in turns, each artifact's bytes (with and without
   ``kernels/``), export seconds, and the seconds of its kernels'
   libraries and first call in each fresh process.
11. train_loop: the seg trainer end to end through the train CLI
   (``tools/train.py:main``), the recipe as it is (upn_tiny_160k_dp03_lr6:
   full width and depth, drop path 0.3, dropout 0.1, bf16 on float32
   masters, batch 16, the auto-sized threaded loader), on a train split of
   the fixture's six images each copied three times (18 items: one batch an
   epoch) and its six val images; warm-up 0, checkpoints every 3, val at 6,
   a log line every step. Run 1, 6 iterations: finite losses, 14 K1 and 14
   K2 launches a step (counts set to 0 just before), every batch read back
   on the card equal to its host batch, ``ckpt_3``, ``ckpt_6`` and
   ``ckpt_best`` with 150 classes in their meta, the in-run val on six
   images, and the test CLI on ``ckpt_best`` giving its counts exactly.
   Run 2: 3 iterations, ``ckpt_3`` restored bit for bit (model, AdamW, step,
   generator), then ``--resume`` to 6. Run 3: 2 iterations with
   ``kernel_impl='pallas'`` (26 K3 launches a step). Prints the loop's ms a
   step and img/s over steps 2-6 and the share of each step spent waiting
   for ``device_prefetch``; the loader alone (img/s at batch 16 with its
   threads on a 48-item split, three batches an epoch, and per item the ms
   of decode, resize, crop, photometric and normalise); the steady state,
   steps 8-14 of 14-iteration runs without checkpoints on the 48-item split,
   with the loader at the preset's log interval, on batches made beforehand
   and held on the card at the preset's log interval, and on those with a
   log line every step (finite losses and 14 K1 and 14 K2 launches a step in
   each); checkpoint save and load seconds, the in-run val's seconds and
   the peak device memory.

12-16. The classifier slice: cls_tiny_imagenet (DAT-T++, 26 blocks, 1000
   classes) at 224², where every stage samples a 7x7 grid (Ns 49).
   cls_kernel_check: K1 (and its log-sum-exp) and K2 against their plain
   versions at the four stage shapes at batch 128 (56²-7² queries, tables
   111-13; stage 3's K2 sums its table gradient over 1024 batch-groups),
   float32 and bf16, the tolerances above. cls_model: the full classifier,
   random weights from the seed, float32, TF32 off: the logits card vs CPU,
   then one train step card vs CPU (drop path 0, CutMix from fixed draws:
   loss, gradients, acc1, under the seg step's gates), with 'auto' and
   'pallas'. cls_serve: ``make_cls_metric_step`` in bf16 at batch 128 with a
   padded tail (counts set to 0 just before: 14 K1 a forward, 2 K3 with
   'pallas'), its ms and img/s with 'auto' and 'pallas' in turns, peak
   memory, profiles. cls_train: the preset as it is (drop path 0.2, mixup,
   clip 5.0, bf16 on float32 masters, warm-up 0) at batch 128: finite
   losses, 14 K1 + 14 K2 launches a step (+ 2 K3 with 'pallas'), ms a step
   and img/s in turns, peak memory, a profile, and K1 and K2 per stage
   beside their bound, plain version and SDPA yardstick. cls_loop: the train
   CLI on ``tests/data/imagenet_tiny`` (batch 4, two epochs of three
   steps): launches, ``ckpt_2``/``best``/``backbone_best``, the in-run val
   counts against a recount on ``best``, a run preempted at step 3 whose
   resume restores ``ckpt_1`` bit for bit (model, AdamW, step, dropout
   generator, mixup sampler); the loader alone (img/s) and per item the ms
   of decode, crop + resize, flip, RandAugment, jitter + normalise, erasing.

17. scale_out: the step over two gloo ranks on the card against one
   process, fsdp against replicated, the distributed eval; one NCCL rank:
   the machinery's cost in turns with the plain step, peak memory
   replicated, fsdp and fsdp with ``use_checkpoint`` (28 K1 and 14 K2
   launches a step, its first loss the fsdp step's); the train CLI under
   torchrun, started by ``tools/launch_multihost.sh`` (one node, one card).
   Its gloo ranks, the torchrun CLI and the one-process references start
   once K1 and K2 are built and run beside phases 3, 4 and 7 (which time
   nothing; 7 runs before 5), done before phase 5; the NCCL rank runs in
   its place, after 16.
17b-17d run their legs in two spawns of gloo ranks on the one card, one of
   two ranks and one of four, and the one-process references in a process
   of their own, all started at once beside the export phase (10b) and
   done before its times (``axis_start``); 17b and 17c at the backbone
   depths ``AXIS_DEPTHS`` (2, 2, 2, 2: 5 'D' blocks, 8 in all), 17d at the
   preset's.
17b. model_axis: fsdp='model' (tensor parallelism, ``parallel/
   model_axis.py``), the flagship at full width (the recipe's drop path
   and dropout), float32, TF32 off, a global batch of two (scale_out's
   rows 0 and 3): two ranks on {data: 1, model: 2} with 'auto', 'pallas',
   in float64 and with the composite modes (``modes``: stage 0's
   continuous bias, one offset group, on K1/K2, stages 1-3 in dwc_pe,
   log_cpb and fixed_pe, split by offset group: ``AXIS_MODES``), four on
   {data: 2, model: 2} with 'auto'; every leaf that the JAX rule shards
   held as a split slice or as a slice gathered at use; each step
   against the one-process step: the loss, the parameters and the IoU
   counts at scale_out's gates, the gradients (gathered whole) reported in
   float32 and held in float64 (1e-9 globally, 1e-6 a leaf;
   ``AXIS_MESHES``' note says why), the ranks' gathered states equal, 5 K1
   + 5 K2 a step on each rank (+ 8 K3 with 'pallas'; the float64 leg runs
   the attention's plain version; 1 K1 + 1 K2 with ``modes``), each
   attention call on the rank's rows and half the groups of a split stage
   (1-3), each rank's parameter + AdamW bytes at most 0.60 of the whole
   and at most the JAX rule's share of the same model plus 0.005
   (``jax_rule_share``, computed here: the card has no JAX), peak memory
   beside the one-process step's. Parity and memory only:
   gloo carries the collectives through the host.
17c. spatial_axis: each image's rows split over the mesh's spatial axis
   (``parallel/spatial.py``), against model_axis's one-process references:
   two ranks on {data: 1, spatial: 2} with 'auto', 'pallas', float64
   and fsdp=True with ``use_checkpoint``, four on {data: 2, spatial: 2}
   (one image a data coordinate: the attention on gathered rows); loss,
   parameters and IoU counts at scale_out's gates, float64 gradients at
   1e-9 globally and 1e-6 a leaf, the ranks' states equal, 5 K1 + 5 K2 a
   step on each rank (+ 8 K3 with 'pallas', 10 K1 with
   ``use_checkpoint``), each K1 call on whole maps of one image, the halo
   rows each fetch adds and the bytes exchanged, peak memory a rank beside
   the one-process step's at two images and at one.
17d. full_mesh: both axes together, at the preset's depth against its
   references: four ranks on {data: 1, model: 2, spatial: 2} (rank
   (d·2 + m)·2 + s,
   the JAX make_mesh order, checked) with fsdp='model' ('auto', 'pallas',
   float64, ``use_checkpoint``) and with fsdp='spatial' (HSDP: parameters
   and AdamW's moments sharded over the spatial peers, the shards held
   against the one-process tensors' rows); loss, parameters, BN statistics
   and IoU counts at scale_out's gates, float64 gradients at 1e-9 globally
   and 1e-6 a leaf, the ranks' states equal, 14 K1 + 14 K2 a step on each
   rank (+ 26 K3 with 'pallas', 28 K1 with ``use_checkpoint``), each K1
   call on whole maps of the rank's image and half the groups of a split
   stage, each K1 launch of the 'auto' leg and each K3 launch of 'pallas'
   against the plain version on its inputs (K2 at each K1 launch's shapes
   on drawn inputs: FULL_MESH_LEGS' note), the halo rows each
   fetch adds on the split channels and the bytes exchanged, bytes and
   peak memory a rank beside the one-process step's, the bytes of each
   fsdp='model' leg at most the JAX rule's share plus 0.005.
18. pe_modes: the position-bias modes the JAX package runs in its
   composite. Each of dwc_pe, fixed_pe, log_cpb, no_off and no position
   bias on all four stages of the full flagship, float32, TF32 off: card
   vs CPU (logits within the model phase's gate, 0 K1 launches). A mixed
   model (dwc_pe on stages 0-1, the continuous bias on stages 2-3) served
   in bf16 at batch 16 (counts set to 0 just before: 11 K1 launches and 3
   composite blocks a forward), in turns with the flagship, peak memory;
   the UperNet preset with that backbone, bf16, batch 16: 11 K1 and 11 K2
   launches a step at attention dropout 0, none at 0.1, and at 0.1 with
   ``use_checkpoint`` the first step's loss and grad norm those of the
   step without it. Then, for the continuous bias and each mode on every
   stage, ms and peak memory of the bf16 forward at batch 16 and of the
   step at the largest of batches 16, 8, 4, 2 that fits; a profile of the
   dwc_pe forward.

Then a ``kernels`` line (K1, K1-v1, K2, K3, with their launches by path),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failed check exits non-zero.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import copy
import itertools
import json
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

SEED = 0
PRESET = "fpn_tiny_80k_dp04_lr2"
TRAIN_PRESET = "upn_tiny_160k_dp03_lr6"
SMALL_PRESET = "upn_small_160k"  # DAT-S++: K3 at C = 96 ... 768
BASE_PRESET = "upn_base_160k"  # DAT-B++: K3 at C = 128 ... 1024 (checked, not served)
IMG = 512
SERVE_BATCH, SERVE_REQUESTS = 4, 4
PREDICT_HW = (512, 683)  # a raw image whose sides are not multiples of 32
SMALL_BATCH = 2
TIME_BATCH = 16
TRAIN_BATCH, TRAIN_STEPS, TIME_STEPS = 16, 10, 5
PALLAS_STEPS = 3
CROP, CROP_BATCH = 544, 2  # a train crop above 512²: Ns 289 at stage 0
K1_VARIANTS = {"no_bias": ("K1_NO_BIAS",)}  # K1 without the bias lookup, timed only
K2_VARIANTS = {"no_bias_grad": ("K2_NO_BIAS_GRAD",)}  # K2 without its bias gradient, timed only
MIN_K1_WARPS = 16  # resident warps an SM that K1's bf16 blocks must reach
MIN_K2_WARPS = 8  # resident warps an SM that K2's bf16 blocks must reach

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# float32: the kernel sums in another order than the plain version and
# uses the fast exp; nothing else differs.
TOL_F32 = 1e-4
# bf16: both round the output to bf16 (one ulp is 2^-8 relative) and the
# plain version also rounds P to bf16 before P·V.
TOL_BF16 = 1e-2
# Full model, float32, TF32 off: cuDNN and the CPU sum convolutions in
# other orders, the kernel as above, over 26 blocks and the FPN.
TOL_MODEL = 1e-3
# K2, each gradient's max |error| over its max |value|: float32 atomics sum
# dk, dv, dpos and dtable in an order that changes from run to run; in
# bf16 dq, dk, dv are rounded to bf16 and the plain version rounds P.
TOL_BWD_F32 = 1e-4
TOL_BWD_BF16 = 2e-2
# K1's log-sum-exp, absolute (values about log Ns): float32 sums in
# another order and the fast exp.
TOL_LSE = 1e-4
# K3, max |error| over max |value| of the plain version: float32, the kernel
# sums its products and depthwise taps in another order; bf16, both round at
# _composite's points, but cuDNN and cuBLAS sum the plain version's convs in
# float32 and round once where the kernel's sums round too, the output's
# one bf16 ulp is 2^-8 relative, and fc2 sums 4C of those rounded values.
TOL_XB_F32 = 1e-4
TOL_XB_BF16 = 1e-2
# One float32 train step of the full UperNet, card against CPU: the loss
# (relative), all gradients (||g_card - g_cpu|| / ||g_cpu||), each
# parameter's gradient (||dg_p|| <= TOL_GRAD_PARAM ||g_p|| + 1e-6 ||g||:
# some gradients, e.g. proj_k.bias, are 0 in exact arithmetic and only
# float32 noise on both sides) and the BN running statistics (absolute).
# The gradient is not continuous in the activations: a ReLU input or a
# bilinear sample position within float32 rounding of its switch point
# goes either way, and each such flip moves a weight gradient by one
# position's share. On the CPU alone, the same step on the image
# perturbed by 1e-6 relative moved all gradients by 8.7e-4 (PERF.md,
# §6): the card's 1.1e-3 sits on that floor, TOL_GRAD at about 3x it.
TOL_TRAIN_LOSS = 1e-5
TOL_GRAD = 3e-3
TOL_GRAD_PARAM = 2e-2
TOL_BN = 1e-4

# 10. eval: the fixture, and its gates.
EVAL_DATA = "tests/data/ade20k_tiny"
LOOP_COPIES = 3  # each fixture image three times in the train split: 18 items
LOOP_ITERS, LOOP_RESUME_AT, LOOP_PALLAS_ITERS = 6, 3, 2
# The loop in steady state: iterations 8-14 of runs without checkpoints and
# with the preset's log interval (no per-step read-back), on a split of 48
# items, three batches an epoch, so the loader runs its two-batches-ahead
# pipeline as on ADE20K (at one batch an epoch it computes one batch at a
# time); by iteration 8 the batches the loader and device_prefetch hold
# ahead (up to five) are spent. Once with the loader, once on batches made
# beforehand and held on the card (no loader threads), and once on those with
# a log line every step: the three split the loop's time into the loader's
# share and the per-step log's.
LOOP_STEADY_COPIES = 8
LOOP_STEADY_FROM, LOOP_STEADY_ITERS = 8, 14
LOOP_SETS = ("schedule.warmup_iters=0", "checkpoint_interval=3", "eval_interval=6",
             "log_interval=1")
# The JPEG decoder against cv2's decodes stored in the fixture: Pillow and
# cv2 both run libjpeg-turbo with its defaults (integer slow DCT, fancy
# upsampling), so they agree unless their builds round a chroma-upsampled
# pixel one grey level apart. A swapped channel order, a missed EXIF
# rotation or another DCT moves most pixels by many levels.
DECODE_MAX_DIFF = 1
DECODE_MAX_SHARE = 0.01
# bf16 eval, batch 4 against batch 1, as a share of the pixels: the batched
# forward (the two 512x512 images) runs other cuDNN and cuBLAS algorithms,
# whose sums round elsewhere, and bf16 keeps 8 bits, so pixels whose top two
# logits are that close may flip; each flip moves the summed |d inter| by at
# most 1 and |d union| by at most 2.
EVAL_BATCH_SHARE = 0.01
# float32 eval, card against CPU, TF32 off: the logits agree within
# TOL_MODEL (phase 4; a bilinear resize does not widen it), so a pixel may
# differ only where the CPU's top two logits are within 2 TOL_MODEL. The
# share bounds how many such ties the random weights may give before the
# comparison says little.
EVAL_F32_TIE = 2 * TOL_MODEL
EVAL_F32_SHARE = 0.01

# 10c. exact_eval: exact padded inference (ops/valid_extent.py). Four images
# of different true sizes in one 512x704 bucket of 32 (stage 0: 128x176
# queries, Ns 16 x 22 = 352 samples). Its float32 forward (TF32 off) against
# each image's true-shape forward on its valid region, as the JAX package's
# tests gate it: the true-shape forward runs K1 and the exact one the
# attention's composite (the JAX gate), and cuDNN picks its convs'
# algorithms by shape, so the two sum in other orders; nothing else differs.
EXACT_SHAPES = ((512, 683), (512, 700), (497, 704), (480, 672))
EXACT_BUCKET, EXACT_BATCH = 32, 4
EXACT_TOL = 1e-4
EXACT_TIME_ITERS = 5

# 10b. export: the flagship's entries (the second holds PREDICT_HW) and the
# gate of tools/export.py --check (bf16 on both sides, the same kernels: only
# a graph that computes something else moves the logits by more)
EXPORT_SHAPES = ((IMG, IMG), (IMG, 704))
EXPORT_TOL_REL = 1e-3

# 12-16. the classifier slice (cls_tiny_imagenet: DAT-T++, 26 blocks, 1000
# classes, 224²). Batch 128 is one card's share of the preset's 1024 over
# eight cards. Every stage samples a 7x7 grid (Ns 49).
CLS_PRESET = "cls_tiny_imagenet"
CLS_IMG = 224
CLS_BATCH = 128
CLS_MODEL_BATCH = 2  # the float32 card-vs-CPU checks
CLS_TRAIN_STEPS, CLS_TIME_STEPS = 4, 5
CLS_DATA = "tests/data/imagenet_tiny"
CLS_LOOP_BATCH, CLS_LOOP_EPOCHS = 4, 2  # 12 train images: 3 steps an epoch
CLS_LOOP_SETS = (f"data.batch_size={CLS_LOOP_BATCH}", "schedule.warmup_iters=0", "log_interval=1")
CLS_LOADER_ITEMS, CLS_LOADER_BATCH = 96, 32  # the loader alone: 3 batches
# ILSVRC-2012 train's commonest sizes (500x375 and 375x500) at its mean file
# size (about 110 KB: 138 GB over 1.28 M files); the fixture's are 96-320 px
CLS_LOADER_SHAPES, CLS_LOADER_QUALITY = ((375, 500), (500, 375)), 90
# the float32 train step card vs CPU replays these draws (CutMix), so that
# both mix the same batch
CLS_DRAWS = dict(use_cutmix=True, lam_mix=0.3, lam_cut=0.55, cy=100, cx=60)

KERNELS = [
    {
        "name": "deform_attn_fwd",
        "route": "cuda",
        "source": "dat_segmentation_tpu_torch/csrc/deform_attn_fwd.cu",
        "replaces": "dat_segmentation_tpu/ops/pallas/deform_attn.py:711",
    },
    {
        "name": "deform_attn_bwd",
        "route": "cuda",
        "source": "dat_segmentation_tpu_torch/csrc/deform_attn_bwd.cu",
        "replaces": "dat_segmentation_tpu/ops/pallas/deform_attn.py:1420",
    },
    {
        "name": "x_block_fwd",
        "route": "cuda",
        "source": "dat_segmentation_tpu_torch/csrc/x_block_fwd.cu",
        "replaces": "dat_segmentation_tpu/ops/pallas/x_block.py:227",
    },
]
XB_PARAMS = ("w3", "b3", "w7", "b7", "g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")

GRADS = ("dq", "dk", "dv", "dpos", "dtable")

failures = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        print(f"chip_smoke: FAILED {what}", file=sys.stderr, flush=True)


def nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


T_START = time.perf_counter()


def mark(name: str) -> None:
    """The phase starting now and the seconds since the start, on stderr: a
    run stopped at a time limit shows where it was."""
    print(f"chip_smoke: {name} at {time.perf_counter() - T_START:.1f} s", file=sys.stderr,
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
    from dataclasses import replace

    from dat_segmentation_tpu_torch.eval.inference import MS_RATIOS
    from dat_segmentation_tpu_torch.ops import cuda_build
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.ops import x_block as xb
    from dat_segmentation_tpu_torch.tools.k3_time import stock_chain, xb_inputs

    card = nvidia_smi_card()
    dev = torch.device("cuda")

    def timed(fn, iters, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    # ---- 1. device ----------------------------------------------------------
    mark("1. device")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nvcc": nvcc[-1] if nvcc else None, "triton": has_triton})

    # ---- 2. build: one nvcc per source, all started together ----------------
    mark("2. build")
    t0 = time.perf_counter()
    sources = [k["source"].rsplit("/", 1)[1] for k in KERNELS]
    builds = ([(src, ()) for src in sources] + [(da.SOURCE, d) for d in K1_VARIANTS.values()]
              + [(da.BWD_SOURCE, d) for d in K2_VARIANTS.values()])

    def build_timed(b):  # one source's nvcc wall time, all started together
        t = time.perf_counter()
        cuda_build.build(*b)
        return time.perf_counter() - t

    # K1's and K2's checks run while K3's nvcc, the longest, still runs
    pool = concurrent.futures.ThreadPoolExecutor(len(builds))
    futures = [pool.submit(build_timed, b) for b in builds]
    k3_build = futures[sources.index(xb.SOURCE)]
    for f in futures:
        if f is not k3_build:
            f.result()

    # ---- 17. scale_out, started: its ranks, the torchrun CLI ('auto': K1
    # and K2) and their references beside phases 3, 4 and 7, which time
    # nothing ------------------------------------------------------------
    mark("17. scale_out: started")
    scale_run = scale_out_start(torch, np, dev)
    atexit.register(scale_out_stop, scale_run)

    # ---- stage geometry of the flagship at 512x512 ---------------------------
    cfg = get_config(PRESET).model
    bb = cfg.backbone
    stages = stage_geometry(bb, IMG)
    scale = 32 ** -0.5

    def k1_inputs(B, g, h_g, Cg, H, W, Ns, th, dtype, pos_range=1.0, seed=SEED, **_):
        rng = np.random.RandomState(seed)
        arrs = [rng.randn(B * g, H, W, Cg) * 0.5, rng.randn(B * g, Ns, Cg) * 0.5,
                rng.randn(B * g, Ns, Cg) * 0.5,
                rng.uniform(-pos_range, pos_range, (B * g, Ns, 2)),
                rng.randn(g, h_g, th, th) * 0.1]
        t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]
        return t[0].to(dtype), t[1].to(dtype), t[2].to(dtype), t[3], t[4].to(dtype)

    # ---- 3. kernel_check ----------------------------------------------------
    mark("3. kernel_check")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [dict(s, B=2, what=f"T++ stage {s['stage']}") for s in stages]
    cases.append(dict(B=2, g=2, h_g=3, Cg=96, H=64, W=64, Ns=256, th=55,
                      what="S++ stage 1 (h_g 3, Cg 96)"))
    cases.append(dict(stages[2], B=2, pos_range=1.2, what="T++ stage 2, pos ~ U(-1.2, 1.2)"))
    cases.append(dict(stages[1], B=2, pos_range=3.0,
                      what="T++ stage 1, pos ~ U(-3, 3) (taps wholly outside the table)"))
    cases.append(dict(B=2, g=2, h_g=2, Cg=64, H=32, W=32, Ns=49, th=55, hn=28, wn=28,
                      what="queries padded 28 -> 32 (hn = wn = 28), Ns 49"))
    cases += [dict(B=2, g=1, h_g=2, Cg=64, H=CROP // 4, W=CROP // 4, Ns=289, th=111,
                   what="stage 0 of a 544x544 crop, Ns 289"),
              dict(B=1, g=1, h_g=2, Cg=64, H=224, W=299, Ns=1064, th=111,
                   what="stage 0 of a 896x1195 image, Ns 1064 (K1 in chunks)")]
    max_err = max_lse_err = 0.0
    for c in cases:
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            q, k, v, pos, table = k1_inputs(dtype=dtype, **c)
            kw = dict(n_groups=c["g"], scale=scale, hn=c.get("hn", 0), wn=c.get("wn", 0))
            with torch.inference_mode():
                got = da.deform_attn(q, k, v, pos, table, **kw)
                ref, ref_lse = da.deform_attn_reference(q, k, v, pos, table, return_lse=True,
                                                        **kw)
                # the launch a training forward makes: with the log-sum-exp
                got_t, lse = da._fwd_kernel(q, k, v, pos, table, kw["n_groups"], scale,
                                            kw["hn"], kw["wn"], with_lse=True)
                torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse.float()).abs().max().item()
            same = torch.equal(got, got_t)
            max_err, max_lse_err = max(max_err, err), max(max_lse_err, lse_err)
            emit({"phase": "kernel_check", "card": card, "kernel": "deform_attn_fwd",
                  "case": c["what"], "dtype": str(dtype).split(".")[1],
                  "q": list(q.shape), "k": list(k.shape), "table": list(table.shape),
                  "samples_a_chunk": da.fwd_chunk(dtype, c["Ns"], c["th"], c["th"]),
                  "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
                  "tol_lse": TOL_LSE, "serving_output_equals_training_launch": same})
            check(err <= tol and got.shape == ref.shape,
                  f"kernel_check {c['what']} {dtype}: {err} > {tol}")
            check(lse_err <= TOL_LSE, f"kernel_check K1 lse {c['what']} {dtype}: {lse_err}")
            check(same, f"kernel_check K1 {c['what']} {dtype}: the log-sum-exp launch moved "
                        "the output")

    # K2: all five gradients against autograd of the plain version
    max_err_bwd = max_rel_bwd = 0.0
    for c in cases:
        for dtype, tol in ((torch.float32, TOL_BWD_F32), (torch.bfloat16, TOL_BWD_BF16)):
            q, k, v, pos, table = k1_inputs(dtype=dtype, **c)
            dout = torch.tensor(np.random.RandomState(SEED + 9).randn(*q.shape),
                                dtype=torch.float32, device=dev).to(dtype)
            kw = dict(n_groups=c["g"], scale=scale, hn=c.get("hn", 0), wn=c.get("wn", 0))
            got = da.deform_attn_bwd(q, k, v, pos, table, dout, **kw)
            ref = da.deform_attn_bwd_reference(q, k, v, pos, table, dout, **kw)
            torch.cuda.synchronize()
            errs, rel = {}, {}
            for name, a, b in zip(GRADS, got, ref):
                errs[name] = (a.float() - b.float()).abs().max().item()
                rel[name] = errs[name] / max(b.float().abs().max().item(), 1e-12)
            max_err_bwd = max(max_err_bwd, *errs.values())
            max_rel_bwd = max(max_rel_bwd, *rel.values())
            emit({"phase": "kernel_check", "card": card, "kernel": "deform_attn_bwd",
                  "case": c["what"], "dtype": str(dtype).split(".")[1], "q": list(q.shape),
                  "table": list(table.shape), "max_abs_err": errs, "max_rel_err": rel,
                  "tol_rel": tol})
            check(max(rel.values()) <= tol
                  and all(a.shape == b.shape for a, b in zip(got, ref)),
                  f"kernel_check K2 {c['what']} {dtype}: {rel} > {tol}")

    # K3's build done: every source's line, the SASS of each
    mark("2. build: K3's nvcc done")
    source_s = [f.result() for f in futures]
    pool.shutdown()
    build_s = time.perf_counter() - t0
    for src, own_s in zip(sources, source_s):
        log = cuda_build.build_log(src)
        emit({"phase": "build", "card": card, "source": src, "seconds": build_s,
              "source_seconds": own_s,
              "flags": " ".join(cuda_build.NVCC_FLAGS),
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if re.search(r"registers|spill", ln)]})
    def sass_of(src):
        return subprocess.run(
            [str(Path(cuda_build.nvcc_path()).parent / "cuobjdump"), "-sass",
             str(cuda_build.library_path(src))], capture_output=True, text=True).stdout

    def mma_count(sass):
        return len(re.findall(r"\bH(?:G)?MMA\b", sass))

    def variants_ptxas(src, variants):
        return {name: [ln.strip() for ln in cuda_build.build_log(src, d).splitlines()
                       if re.search(r"registers|spill", ln)]
                for name, d in variants.items()}

    cfg_bb = get_config(PRESET).model.backbone
    tables = sorted({2 * (cfg_bb.img_size // cfg_bb.patch_size >> i) - 1 for i in range(4)},
                    reverse=True)
    k1_sass = sass_of(da.SOURCE)
    k1_mma = mma_count(k1_sass)
    k1_occupancy = {}
    for th in tables:
        for dt in (torch.bfloat16, torch.float32):
            blocks, warps = da.fwd_resident_warps(dt, 256, th, th)
            k1_occupancy.setdefault(f"table {th}", {})[str(dt).split(".")[1]] = {
                "smem_bytes": da.smem_bytes(dt, 256, th, th), "blocks_per_sm": blocks,
                "warps_per_sm": warps}
    k1_warps = min(v["bfloat16"]["warps_per_sm"] for v in k1_occupancy.values())
    emit({"phase": "build", "card": card, "source": da.SOURCE, "occupancy_ns256": k1_occupancy,
          "smem_bytes_stage0": {"float32": da.smem_bytes(torch.float32, 256, 111, 111),
                                "bfloat16": da.smem_bytes(torch.bfloat16, 256, 111, 111)},
          "min_bf16_warps_per_sm": k1_warps, "mma_instructions": k1_mma,
          "sass_instructions": len(re.findall(r"/\*[0-9a-f]{4}\*/", k1_sass)),
          "attribution_builds_ptxas": variants_ptxas(da.SOURCE, K1_VARIANTS)})
    check(k1_warps >= MIN_K1_WARPS,
          f"build: K1 bf16 keeps {k1_warps} warps an SM resident, want >= {MIN_K1_WARPS}")
    check(k1_mma > 0, "build: no HMMA/HGMMA instruction in K1's SASS")
    sass = sass_of(da.BWD_SOURCE)
    k2_mma = mma_count(sass)
    # a float32 atomic add to shared memory is a compare-and-swap loop here
    k2_cas = len(re.findall(r"\bATOMS\.CAST?\b", sass))
    k2_occupancy = {}
    for th in tables:
        for dt in (torch.bfloat16, torch.float32):
            blocks, warps = da.bwd_resident_warps(dt, th, th)
            k2_occupancy.setdefault(f"table {th}", {})[str(dt).split(".")[1]] = {
                "smem_bytes": da.bwd_smem_bytes(dt, th, th), "blocks_per_sm": blocks,
                "warps_per_sm": warps}
    k2_warps = min(v["bfloat16"]["warps_per_sm"] for v in k2_occupancy.values())
    variant_ptxas = variants_ptxas(da.BWD_SOURCE, K2_VARIANTS)
    emit({"phase": "build", "card": card, "source": da.BWD_SOURCE, "occupancy": k2_occupancy,
          "min_bf16_warps_per_sm": k2_warps, "mma_instructions": k2_mma,
          "shared_cas_instructions": k2_cas,
          "sass_instructions": len(re.findall(r"/\*[0-9a-f]{4}\*/", sass)),
          "attribution_builds_ptxas": variant_ptxas,
          "smem_bytes_max_per_block": torch.cuda.get_device_properties(0).shared_memory_per_block_optin})
    check(k2_warps >= MIN_K2_WARPS,
          f"build: K2 bf16 keeps {k2_warps} warps an SM resident, want >= {MIN_K2_WARPS}")
    check(k2_mma > 0, "build: no HMMA/HGMMA instruction in K2's SASS")
    k3_mma = mma_count(sass_of(xb.SOURCE))
    k3_tiles = []
    for C in (64, 96, 128, 192, 256, 384, 512, 768, 1024):
        for name, mode, k in (("X", xb.MODE_X_LPU, 7), ("mlp", xb.MODE_MLP, 1)):
            for dt in (torch.bfloat16, torch.float32):
                blocks, warps = xb.resident_warps(dt, C, mode, k)
                k3_tiles.append({"C": C, "mode": name, "dtype": str(dt).split(".")[1],
                                 "tile": [xb.tile_rows(dt, C, mode, k), 8],
                                 "smem_bytes": xb.smem_bytes(dt, C, mode, k),
                                 "registers": xb.registers(dt, C, mode, k),
                                 "blocks_per_sm": blocks, "warps_per_sm": warps})
    # the flagship's bf16 instances (T++ widths)
    k3_warps = min(t["warps_per_sm"] for t in k3_tiles
                   if t["dtype"] == "bfloat16" and t["C"] in cfg_bb.dims)
    emit({"phase": "build", "card": card, "source": xb.SOURCE, "tiles": k3_tiles,
          "min_bf16_warps_per_sm": k3_warps, "mma_instructions": k3_mma})
    check(k3_mma > 0, "build: no HMMA/HGMMA instruction in K3's SASS")
    check(all(t["tile"][0] > 0 and t["blocks_per_sm"] > 0 for t in k3_tiles),
          "build: a K3 width without a tile that fits the card")

    xb_bound = x_block_bound(cfg.backbone, stages, card)
    emit(xb_bound)

    mark("3. kernel_check: K3")
    # K3: both modes at the four T++ stage shapes (batch 2), the four S++
    # widths, the four B++ widths in both modes, no LPU, a rectangular image,
    # sides that are not multiples of the tile, windows 3, 5 and 9; each
    # case launched twice, equal bit for bit (K3 has no atomics)
    sdims = get_config(SMALL_PRESET).model.backbone.dims
    bdims = get_config(BASE_PRESET).model.backbone.dims
    xcases = [dict(B=2, H=s["H"], W=s["W"], C=cfg.backbone.dims[s["stage"]], mode=m,
                   what=f"T++ stage {s['stage']} {m}") for s in stages for m in ("lpu", "mlp")]
    xcases += [dict(B=1, H=s["H"], W=s["W"], C=sdims[s["stage"]],
                    mode="mlp" if s["stage"] == 3 else "lpu", what=f"S++ stage {s['stage']}")
               for s in stages]
    xcases += [dict(B=2, H=64, W=64, C=128, mode="x", what="no LPU"),
               dict(B=2, H=48, W=80, C=64, mode="lpu", what="rectangular 48x80"),
               dict(B=2, H=32, W=32, C=64, k=3, mode="lpu", what="window 3"),
               dict(B=2, H=32, W=32, C=64, k=5, mode="lpu", what="window 5"),
               dict(B=2, H=32, W=32, C=64, k=9, mode="lpu", what="window 9"),
               dict(B=2, H=20, W=36, C=64, mode="lpu", what="20x36 (sides not tile multiples)"),
               dict(B=2, H=20, W=36, C=64, mode="mlp", what="20x36 mlp")]
    xcases += [dict(B=1, H=h, W=h, C=C, mode=m, what=f"B++ C={C} {m}")
               for C, h in zip(bdims, (32, 32, 16, 16)) for m in ("lpu", "mlp")]
    max_err_xb = max_rel_xb = 0.0
    for c in xcases:
        for dtype, tol in ((torch.float32, TOL_XB_F32), (torch.bfloat16, TOL_XB_BF16)):
            x, prm = xb_inputs(dev, dtype, **c)
            args = [prm[n] for n in XB_PARAMS]
            with torch.inference_mode():
                got = xb.x_block_fwd(x, *args, with_lpu=c["mode"] == "lpu")
                again = xb.x_block_fwd(x, *args, with_lpu=c["mode"] == "lpu")
                ref = xb.x_block_reference(x, *args, with_lpu=c["mode"] == "lpu")
                torch.cuda.synchronize()
            same = torch.equal(got, again)
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            max_err_xb, max_rel_xb = max(max_err_xb, err), max(max_rel_xb, rel)
            emit({"phase": "kernel_check", "card": card, "kernel": "x_block_fwd",
                  "case": c["what"], "dtype": str(dtype).split(".")[1], "x": list(x.shape),
                  "k": c.get("k", 7), "mode": c["mode"], "max_abs_err": err,
                  "max_rel_err": rel, "tol_rel": tol, "two_launches_equal": same})
            check(rel <= tol and got.shape == ref.shape and got.dtype == dtype,
                  f"kernel_check K3 {c['what']} {dtype}: {rel} > {tol}")
            check(same, f"kernel_check K3 {c['what']} {dtype}: two launches differ")

    # ---- 4. model: kernel path on the card vs the plain path on the CPU ------
    mark("4. model")
    torch.manual_seed(SEED)
    model = build_model(cfg, device=dev)
    image = torch.tensor(np.random.RandomState(SEED + 1).randn(1, IMG, IMG, 3),
                         dtype=torch.float32)
    da.deform_attn.launches = 0
    with torch.inference_mode():
        gpu_logits = model(image.to(dev)).float()
        torch.cuda.synchronize()
        gpu_launches = da.deform_attn.launches
        t0 = time.perf_counter()
        cpu_logits = copy.deepcopy(model).cpu()(image)
        cpu_s = time.perf_counter() - t0
    dlogit = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    agree = (gpu_logits.cpu().argmax(-1) == cpu_logits.argmax(-1)).float().mean().item()
    emit({"phase": "model", "card": card, "preset": PRESET, "dtype": "float32",
          "tf32": False, "input": list(image.shape), "logits": list(gpu_logits.shape),
          "max_abs_dlogit": dlogit, "tol": TOL_MODEL,
          "logit_absmax": cpu_logits.abs().max().item(), "argmax_agreement": agree,
          "kernel_launches": gpu_launches, "cpu_forward_s": cpu_s})
    check(dlogit <= TOL_MODEL, f"model f32: max |dlogit| {dlogit} > {TOL_MODEL}")
    check(bool(torch.isfinite(gpu_logits).all()), "model f32: non-finite logits")
    n_d = sum(s["launches_per_forward"] for s in stages)
    check(gpu_launches == n_d, f"model f32: {gpu_launches} K1 launches, want {n_d}")

    # the same weights with kernel_impl='pallas': K3 on the card
    pcfg = replace(cfg, backbone=replace(cfg.backbone, kernel_impl="pallas"))
    pmodel = build_model(pcfg, device=dev)
    pmodel.load_state_dict(model.state_dict())
    n_x = sum(cfg.backbone.depths)  # one K3 launch a block: 12 'X', 14 MLP-only
    da.deform_attn.launches = xb.x_block_fwd.launches = 0
    with torch.inference_mode():
        fused_logits = pmodel(image.to(dev)).float()
        torch.cuda.synchronize()
        fused_launches = (xb.x_block_fwd.launches, da.deform_attn.launches)
        cpu_fused = copy.deepcopy(pmodel).cpu()(image)
    d_cpu = (fused_logits.cpu() - cpu_fused).abs().max().item()
    d_unfused = (fused_logits - gpu_logits).abs().max().item()
    emit({"phase": "model", "card": card, "preset": PRESET, "kernel_impl": "pallas",
          "dtype": "float32", "tf32": False, "max_abs_dlogit_vs_cpu": d_cpu,
          "max_abs_dlogit_vs_card_unfused": d_unfused, "tol": TOL_MODEL,
          "argmax_agreement_vs_cpu":
              (fused_logits.cpu().argmax(-1) == cpu_fused.argmax(-1)).float().mean().item(),
          "kernel_launches": {"x_block_fwd": fused_launches[0],
                              "deform_attn_fwd": fused_launches[1]}})
    check(d_cpu <= TOL_MODEL, f"model f32 pallas: card vs CPU {d_cpu} > {TOL_MODEL}")
    check(d_unfused <= TOL_MODEL, f"model f32 pallas: fused vs unfused {d_unfused} > {TOL_MODEL}")
    check(fused_launches == (n_x, n_d),
          f"model f32 pallas: launches (K3, K1) {fused_launches}, want {(n_x, n_d)}")
    del cpu_fused

    # ---- 7. train_model: one float32 step, kernel path vs plain path ---------
    mark("7. train_model")
    from dat_segmentation_tpu_torch import create_train_state, make_train_step

    ucfg = get_config(TRAIN_PRESET)
    mc = ucfg.model

    def no_warmup(model_cfg):
        return replace(ucfg, model=model_cfg, schedule=replace(ucfg.schedule, warmup_iters=0))

    def seg_batch(B, seed, device, size=IMG):
        rng = np.random.RandomState(seed)
        label = rng.randint(0, mc.num_classes, (B, size, size))
        label[rng.rand(B, size, size) < 0.05] = 255
        return {"image": torch.tensor(rng.randn(B, size, size, 3), dtype=torch.float32,
                                      device=device),
                "label": torch.tensor(label, dtype=torch.long, device=device)}

    quiet = replace(
        mc, backbone=replace(mc.backbone, drop_path_rate=0.0),
        decode_head=replace(mc.decode_head, kwargs={**mc.decode_head.kwargs, "dropout_ratio": 0.0}),
        auxiliary_head=replace(mc.auxiliary_head,
                               kwargs={**mc.auxiliary_head.kwargs, "dropout_ratio": 0.0}),
    )
    for impl in ("auto", "pallas"):
        qcfg = replace(quiet, backbone=replace(quiet.backbone, kernel_impl=impl))
        torch.manual_seed(SEED)
        gmodel = build_model(qcfg, device=dev)
        cmodel = copy.deepcopy(gmodel).cpu()
        b2 = seg_batch(2, SEED + 4, "cpu")
        runs = {}
        for where, m in (("card", gmodel), ("cpu", cmodel)):
            st = create_train_state(m, no_warmup(qcfg))
            stp = make_train_step(m, aux_weight=mc.aux_loss_weight, num_classes=mc.num_classes,
                                  compute_dtype=torch.float32)
            da.deform_attn.launches = da.deform_attn_bwd.launches = xb.x_block_fwd.launches = 0
            t0 = time.perf_counter()
            _, met = stp(st, b2)
            if where == "card":
                torch.cuda.synchronize()
            runs[where] = dict(metrics={k: v.cpu() for k, v in met.items()},
                               seconds=time.perf_counter() - t0,
                               launches=(da.deform_attn.launches, da.deform_attn_bwd.launches),
                               k3=xb.x_block_fwd.launches)
        gm, cm = runs["card"]["metrics"], runs["cpu"]["metrics"]
        loss_rel = abs(gm["loss"].item() - cm["loss"].item()) / abs(cm["loss"].item())
        grad_rel, worst, off, per_param, gsq = grad_compare(gmodel, cmodel)
        bn_err = max((b.cpu() - cb).abs().max().item()
                     for (n, b), (_, cb) in zip(gmodel.named_buffers(), cmodel.named_buffers())
                     if n.endswith(("running_mean", "running_var")))
        iou_diff = int((gm["inter"] - cm["inter"]).abs().sum() + (gm["union"] - cm["union"]).abs().sum())
        pixels = b2["label"].numel()
        n_d = sum(s["launches_per_forward"] for s in stages)
        emit({"phase": "train_model", "card": card, "preset": TRAIN_PRESET, "dtype": "float32",
              "kernel_impl": impl, "x_block_fwd_launches": runs["card"]["k3"],
              "tf32": False, "batch": list(b2["image"].shape), "drop_path": 0.0, "dropout": 0.0,
              "loss_card": gm["loss"].item(), "loss_cpu": cm["loss"].item(), "loss_rel_err": loss_rel,
              "grad_rel_err": grad_rel, "worst_param": worst[2],
              "worst_param_rel_err": worst[0] / max(worst[1], 1e-30),
              "worst_param_grad_norm": worst[1], "grad_norm_total": gsq ** 0.5,
              "largest_grad_errs": [{"param": n, "abs": d, "norm": g}
                                    for d, g, n in sorted(per_param, reverse=True)[:6]],
              "bn_stats_max_abs_err": bn_err, "iou_counts_equal": iou_diff == 0,
              "iou_count_abs_diff": iou_diff, "pixels": pixels,
              "launches": {"deform_attn_fwd": runs["card"]["launches"][0],
                           "deform_attn_bwd": runs["card"]["launches"][1]},
              "card_step_s": runs["card"]["seconds"], "cpu_step_s": runs["cpu"]["seconds"],
              "beside": "scale_out's ranks and torchrun CLI",
              "tol": {"loss": TOL_TRAIN_LOSS, "grad": TOL_GRAD, "grad_param": TOL_GRAD_PARAM,
                      "bn": TOL_BN}})
        check(loss_rel <= TOL_TRAIN_LOSS, f"train_model {impl}: loss rel err {loss_rel} > {TOL_TRAIN_LOSS}")
        check(grad_rel <= TOL_GRAD, f"train_model {impl}: grad rel err {grad_rel} > {TOL_GRAD}")
        check(not off, f"train_model {impl}: gradients beyond {TOL_GRAD_PARAM}: {off}")
        check(bn_err <= TOL_BN, f"train_model {impl}: BN statistics off by {bn_err} > {TOL_BN}")
        # argmax near-ties may flip under float32 rounding: a few pixels, never more
        check(iou_diff <= 1e-4 * pixels, f"train_model {impl}: IoU counts differ by {iou_diff}")
        check(runs["card"]["launches"] == (n_d, n_d),
              f"train_model {impl}: launches {runs['card']['launches']}, want ({n_d}, {n_d})")
        check(runs["card"]["k3"] == (n_x if impl == "pallas" else 0),
              f"train_model {impl}: {runs['card']['k3']} K3 launches")
        del gmodel, cmodel, runs
        torch.cuda.empty_cache()

    # ---- 17. scale_out's processes done before anything is timed -----------
    mark("17. scale_out: waiting for its processes")
    scale_out_wait(scale_run)

    # ---- 5. serve: the main path, counts set to 0 just before ---------------
    mark("5. serve")
    server = SegInferencer(model, num_classes=cfg.num_classes, device=dev)
    rng = np.random.RandomState(SEED + 2)
    requests = [rng.randn(SERVE_BATCH, IMG, IMG, 3).astype(np.float32)
                for _ in range(SERVE_REQUESTS)]
    da.deform_attn.launches = 0
    t0 = time.perf_counter()
    (outs, whole), ran = device_launches(torch, lambda: (
        [server.forward_batch(r) for r in requests], server.logits_whole(image[0].numpy())))
    serve_s = time.perf_counter() - t0
    launches = {"deform_attn_fwd": ran["deform_attn_fwd"]}
    forwards = SERVE_REQUESTS + 1
    routes = dict(server._graphs.routes)
    python_fwds = routes.get("eager", 0) + routes.get("capture", 0)
    shapes_ok = all(tuple(o.shape) == (SERVE_BATCH, IMG // 4, IMG // 4, cfg.num_classes)
                    and bool(torch.isfinite(o).all()) for o in outs)
    whole_ok = whole.shape == (IMG, IMG, cfg.num_classes) and bool(np.isfinite(whole).all())
    bf16_d = float(np.abs(whole - gpu_logits[0].cpu().numpy()).max())
    bf16_agree = float((whole.argmax(-1) == gpu_logits[0].cpu().numpy().argmax(-1)).mean())
    emit({"phase": "serve", "card": card, "dtype": "bfloat16", "requests": SERVE_REQUESTS,
          "batch": SERVE_BATCH, "whole_images": 1, "profiled_wall_s": serve_s,
          "launches": launches, "launches_per_forward": launches["deform_attn_fwd"] / forwards,
          "routes": routes, "wrapper_launches": {"deform_attn_fwd": da.deform_attn.launches},
          "outputs_ok": shapes_ok and whole_ok,
          "bf16_vs_f32_max_abs_dlogit": bf16_d, "bf16_vs_f32_argmax_agreement": bf16_agree})
    check(shapes_ok and whole_ok, "serve: outputs of the wrong shape or not finite")
    check(launches["deform_attn_fwd"] == n_d * forwards,
          f"serve: {launches['deform_attn_fwd']} K1 kernels on the card, want {n_d * forwards}")
    check(routes == {"eager": 2, "capture": 1, "replay": SERVE_REQUESTS - 2}
          and da.deform_attn.launches == n_d * python_fwds,
          f"serve: routes {routes}, {da.deform_attn.launches} K1 wrapper calls, want "
          f"{n_d} a forward that ran its Python")

    # serve_pallas: the same requests with K3; then predict on a raw image
    pserver = SegInferencer(pmodel, num_classes=cfg.num_classes, device=dev)
    seen = []  # the (B, H, W) of every forward, replayed from a CUDA graph or not
    serve_batch = pserver.forward_batch

    def recorded_batch(images, valid_hw=None):
        seen.append(tuple(images.shape[:3]))
        return serve_batch(images, valid_hw)

    pserver.forward_batch = recorded_batch
    da.deform_attn.launches = xb.x_block_fwd.launches = 0
    t0 = time.perf_counter()
    pouts, ran = device_launches(torch, lambda: [pserver.forward_batch(r) for r in requests])
    pserve_s = time.perf_counter() - t0
    pserve_launches = {k: ran[k] for k in ("x_block_fwd", "deform_attn_fwd")}
    pwrapper = {"x_block_fwd": xb.x_block_fwd.launches,
                "deform_attn_fwd": da.deform_attn.launches}
    proutes = dict(pserver._graphs.routes)
    pshapes_ok = all(tuple(o.shape) == (SERVE_BATCH, IMG // 4, IMG // 4, cfg.num_classes)
                     and bool(torch.isfinite(o).all()) for o in pouts)
    agree = float(np.mean([(a.argmax(-1) == b.argmax(-1)).float().mean().item()
                           for a, b in zip(pouts, outs)]))
    emit({"phase": "serve_pallas", "card": card, "dtype": "bfloat16", "kernel_impl": "pallas",
          "requests": SERVE_REQUESTS, "batch": SERVE_BATCH, "profiled_wall_s": pserve_s,
          "launches": pserve_launches, "routes": proutes, "wrapper_launches": pwrapper,
          "launches_per_forward": {k: v / SERVE_REQUESTS for k, v in pserve_launches.items()},
          "outputs_ok": pshapes_ok, "argmax_agreement_vs_unfused_bf16": agree})
    check(pshapes_ok, "serve_pallas: outputs of the wrong shape or not finite")
    check(pserve_launches == {"x_block_fwd": n_x * SERVE_REQUESTS,
                              "deform_attn_fwd": n_d * SERVE_REQUESTS},
          f"serve_pallas: launches {pserve_launches}, want {n_x} K3 and {n_d} K1 a forward")
    check(proutes == {"eager": 1, "capture": 1, "replay": SERVE_REQUESTS - 2}
          and pwrapper == {"x_block_fwd": 2 * n_x, "deform_attn_fwd": 2 * n_d},
          f"serve_pallas: routes {proutes}, wrapper calls {pwrapper}, want those of 2 forwards")

    raw = np.random.RandomState(SEED + 6).randint(0, 256, (*PREDICT_HW, 3)).astype(np.uint8)
    predict_launches = {}
    for name, mode, kw in (("slide", "slide", {}),
                           ("ms_flip", "whole", dict(ratios=MS_RATIOS, flip=True))):
        pserver.mode = mode
        seen.clear()
        routes0 = Counter(pserver._graphs.routes)
        t0 = time.perf_counter()
        pred, ran = device_launches(torch, lambda: pserver.predict(raw, **kw))
        pred_s = time.perf_counter() - t0
        got = (ran["x_block_fwd"], ran["deform_attn_fwd"])
        want = (sum(k3_gate_count(cfg.backbone, h, w) for _, h, w in seen), n_d * len(seen))
        predict_launches[name] = got[0]
        ok = bool(pred.shape == PREDICT_HW and pred.dtype == np.int32
                  and 0 <= pred.min() and pred.max() < cfg.num_classes)
        emit({"phase": "serve_pallas", "card": card, "request": f"predict {name}",
              "mode": mode, "raw": list(raw.shape), "ratios": list(kw.get("ratios", (1.0,))),
              "flip": kw.get("flip", False), "forwards": [list(s) for s in seen],
              "routes": dict(Counter(pserver._graphs.routes) - routes0),
              "k3_launches": got[0], "k3_gate_count": want[0], "k1_launches": got[1],
              "classes_present": int(len(np.unique(pred))), "output_ok": ok,
              "profiled_wall_s": pred_s})
        check(ok, f"serve_pallas: predict {name} gave {pred.shape} {pred.dtype}")
        check(got == want, f"serve_pallas: predict {name} launches (K3, K1) {got}, want {want}")
    del pserver.forward_batch
    pserver.mode = "whole"

    # serve_small: DAT-S++ UperNet at full width and depth, K3 at C = 96 ... 768
    scfg = get_config(SMALL_PRESET).model
    scfg = replace(scfg, backbone=replace(scfg.backbone, kernel_impl="pallas"))
    torch.manual_seed(SEED)
    sserver = SegInferencer(build_model(scfg, device=dev), num_classes=scfg.num_classes,
                            device=dev)
    xs2 = np.random.RandomState(SEED + 7).randn(SMALL_BATCH, IMG, IMG, 3).astype(np.float32)
    da.deform_attn.launches = xb.x_block_fwd.launches = 0
    sout = sserver.forward_batch(xs2)
    torch.cuda.synchronize()
    s_launches = (xb.x_block_fwd.launches, da.deform_attn.launches)
    s_want = (sum(scfg.backbone.depths),
              sum(spec.count("D") for spec in scfg.backbone.stage_spec))
    s_ok = (tuple(sout.shape) == (SMALL_BATCH, IMG // 4, IMG // 4, scfg.num_classes)
            and bool(torch.isfinite(sout).all()))
    emit({"phase": "serve_small", "card": card, "preset": SMALL_PRESET, "kernel_impl": "pallas",
          "dtype": "bfloat16", "batch": SMALL_BATCH, "dims": list(scfg.backbone.dims),
          "logits": list(sout.shape), "finite": s_ok,
          "launches": {"x_block_fwd": s_launches[0], "deform_attn_fwd": s_launches[1]}})
    check(s_ok, "serve_small: logits of the wrong shape or not finite")
    check(s_launches == s_want, f"serve_small: launches (K3, K1) {s_launches}, want {s_want}")
    del sserver, sout
    torch.cuda.empty_cache()

    # ---- 6. times -------------------------------------------------------------
    mark("6. times")
    def k1_stage_time(s, B):
        """K1 at one stage's shapes, batch B, bf16: ms (and its attribution
        build's), the plain version's, one SDPA with the bias prebuilt, and
        the bound."""
        q, k, v, pos, table = k1_inputs(B=B, dtype=torch.bfloat16, **s)
        BG, H, W, Cg = q.shape
        Ns, h_g, th = s["Ns"], s["h_g"], s["th"]
        kw = dict(n_groups=s["g"], scale=scale)
        with torch.inference_mode():
            ms = timed(lambda: da.deform_attn(q, k, v, pos, table, **kw), 20)
            variant_ms = {name: timed(lambda: da._fwd_launch(da._library(d), q, k, v, pos, table,
                                                             s["g"], scale, 0, 0), 20)
                          for name, d in K1_VARIANTS.items()}
            plain_ms = timed(lambda: da.deform_attn_reference(q, k, v, pos, table, **kw), 3, 1)
            qs = q.reshape(BG, H * W, h_g, 32).transpose(1, 2).contiguous()
            ks = k.reshape(BG, Ns, h_g, 32).transpose(1, 2).contiguous()
            vs = v.reshape(BG, Ns, h_g, 32).transpose(1, 2).contiguous()
            bias = da.rpe_bias(pos, table, H, W).to(torch.bfloat16)
            lib_ms = timed(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=bias, scale=scale), 10)
            del bias
        ops = 4.0 * BG * H * W * Ns * Cg
        nbytes = (2 * q.numel() + k.numel() + v.numel() + table.numel()) * 2 + pos.numel() * 4
        ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        return {"kernel": "deform_attn_fwd", "stage": s["stage"], "dtype": "bfloat16",
                "batch": B, "q": list(q.shape), "k": list(k.shape), "table": list(table.shape),
                "launches_per_forward": s["launches_per_forward"], "ms": ms,
                "plain_ms": plain_ms, "attribution_ms": variant_ms,
                "library": "scaled_dot_product_attention, bias prebuilt (lookup not timed)",
                "library_ms": lib_ms, "bound_ms": bound_ms, "ops_ms": ops_ms,
                "bytes_ms": bytes_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "roofline_share": bound_ms / ms}

    def k2_stage_time(s, B):
        """K2 at one stage's shapes, batch B, bf16, as ``k1_stage_time``; the
        yardstick is SDPA's backward with the bias prebuilt."""
        q, k, v, pos, table = k1_inputs(B=B, dtype=torch.bfloat16, **s)
        dout = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(SEED),
                           device=dev).to(torch.bfloat16)
        BG, H, W, Cg = q.shape
        Ns, h_g = s["Ns"], s["h_g"]
        kw = dict(n_groups=s["g"], scale=scale)
        out, lse = da._fwd_kernel(q, k, v, pos, table, s["g"], scale, 0, 0, with_lse=True)
        ms = timed(lambda: da.deform_attn_bwd(q, k, v, pos, table, dout, out=out, lse=lse,
                                              **kw), 10)
        variant_ms = {name: timed(lambda: da._bwd_launch(da._bwd_library(d), q, k, v, pos, table,
                                                         dout, out, lse, s["g"], scale, 0, 0), 10)
                      for name, d in K2_VARIANTS.items()}
        plain_ms = timed(lambda: da.deform_attn_bwd_reference(q, k, v, pos, table, dout, **kw), 3, 1)
        heads = [t.reshape(BG, -1, h_g, 32).transpose(1, 2).contiguous().requires_grad_(True)
                 for t in (q, k, v)]
        bias = da.rpe_bias(pos, table, H, W).to(torch.bfloat16).requires_grad_(True)
        out = F.scaled_dot_product_attention(*heads, attn_mask=bias, scale=scale)
        d_out = dout.reshape(BG, H * W, h_g, 32).transpose(1, 2).contiguous()
        lib_ms = timed(lambda: torch.autograd.grad(out, heads + [bias], d_out, retain_graph=True), 5)
        del out, heads, bias
        ops = 10.0 * BG * H * W * Ns * Cg
        # the gradient's own traffic: read q, k, v, table, dout (bf16) and pos;
        # write dq (bf16), dk, dv, dpos, dtable (float32). The out and lse
        # that this design also reads are not counted.
        nbytes = ((3 * q.numel() + k.numel() + v.numel() + table.numel()) * 2
                  + (k.numel() + v.numel() + 2 * pos.numel() + table.numel()) * 4)
        ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        return {"kernel": "deform_attn_bwd", "stage": s["stage"], "dtype": "bfloat16",
                "batch": B, "q": list(q.shape), "k": list(k.shape), "table": list(table.shape),
                "launches_per_step": s["launches_per_forward"], "ms": ms, "plain_ms": plain_ms,
                "attribution_ms": variant_ms,
                "library": "scaled_dot_product_attention backward, bias prebuilt and requiring "
                           "grad (the bias -> pos, table chain not timed)",
                "library_ms": lib_ms, "bound_ms": bound_ms, "ops_ms": ops_ms,
                "bytes_ms": bytes_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "roofline_share": bound_ms / ms}

    def add_stage(tot, row):
        n = row["launches_per_forward" if "launches_per_forward" in row else "launches_per_step"]
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms"):
            tot[key] = tot.get(key, 0.0) + row[key] * n
        for v, t in row["attribution_ms"].items():
            tot[f"{v}_ms"] = tot.get(f"{v}_ms", 0.0) + t * n

    totals = {}
    for s in stages:
        row = k1_stage_time(s, TIME_BATCH)
        add_stage(totals, row)
        emit({"phase": "kernel_time", "card": card, **row})

    xtot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "chain_ms": 0.0,
            "ops_ms": 0.0, "bytes_ms": 0.0}
    for row in xb_bound["rows"]:
        mode = "lpu" if row["mode"] == "X" else "mlp"
        B, H, W, C = row["x"]
        x, prm = xb_inputs(dev, torch.bfloat16, B=B, H=H, W=W, C=C, k=row["k"], mode=mode)
        args = [prm[n] for n in XB_PARAMS]
        lpu = mode == "lpu"
        with torch.inference_mode():
            ms = timed(lambda: xb.x_block_fwd(x, *args, with_lpu=lpu), 20)
            plain_ms = timed(lambda: xb.x_block_reference(x, *args, with_lpu=lpu), 5, 1)
            chain_ms = timed(lambda: stock_chain(x, prm, mode), 10)
        n = row["calls_per_forward"]
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", row["bound_ms"]),
                         ("chain_ms", chain_ms), ("ops_ms", row["ops_ms"]),
                         ("bytes_ms", row["bytes_ms"])):
            xtot[key] += val * n
        emit({"phase": "kernel_time", "card": card, "kernel": "x_block_fwd",
              "stage": row["stage"], "mode": row["mode"], "dtype": "bfloat16", "batch": B,
              "x": row["x"], "k": row["k"],
              "tile": [xb.tile_rows(torch.bfloat16, C, xb.MODE_X_LPU if lpu else xb.MODE_MLP,
                                    row["k"]), 8],
              "launches_per_forward": n, "ms": ms, "plain_ms": plain_ms,
              "yardstick": "the unfused stock-op chain (cuDNN depthwise convs, LayerNorm, "
                           "cuBLAS linears, GELU), not one call",
              "chain_ms": chain_ms, "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
              "roofline_share": row["bound_ms"] / ms, "chain_over_kernel": chain_ms / ms})
        del x, prm, args

    x16 = torch.tensor(np.random.RandomState(SEED + 3).randn(TIME_BATCH, IMG, IMG, 3),
                       dtype=torch.bfloat16, device=dev)
    fwd_ms = timed(lambda: server.forward_batch(x16), 5)
    torch.cuda.reset_peak_memory_stats()
    server.forward_batch(x16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "forward_time", "card": card, "dtype": "bfloat16", "batch": TIME_BATCH,
          "ms": fwd_ms, "ms_per_img": fwd_ms / TIME_BATCH,
          "img_per_s": TIME_BATCH / fwd_ms * 1e3, "peak_mem_gib": peak / 2 ** 30,
          "deform_attn_fwd_ms": totals["ms"],
          "deform_attn_fwd_share": totals["ms"] / fwd_ms})
    emit(profile_device(torch, lambda: server.forward_batch(x16), card, fwd_ms, "forward"))

    # the forward with 'auto' and 'pallas' in turns (auto, pallas, pallas, auto,
    # three times: the host holds some runs back)
    servers = {"auto": server, "pallas": pserver}
    fwd = {"auto": [], "pallas": []}
    peak_by = {}
    for impl in ("auto", "pallas", "pallas", "auto") * 3:
        fwd[impl].append(timed(lambda: servers[impl].forward_batch(x16), 5))
    for impl, srv in servers.items():
        torch.cuda.reset_peak_memory_stats()
        srv.forward_batch(x16)
        torch.cuda.synchronize()
        peak_by[impl] = torch.cuda.max_memory_allocated() / 2 ** 30
    pfwd_ms = statistics.median(fwd["pallas"])
    emit({"phase": "forward_time", "card": card, "dtype": "bfloat16", "batch": TIME_BATCH,
          "compare": "kernel_impl auto vs pallas, in turns",
          "order": "(auto pallas pallas auto) x 3", "ms": fwd,
          "median_ms": {k: statistics.median(vs) for k, vs in fwd.items()},
          "img_per_s": {k: [TIME_BATCH / v * 1e3 for v in vs] for k, vs in fwd.items()},
          "peak_mem_gib": peak_by, "x_block_fwd_ms": xtot["ms"],
          "x_block_chain_ms": xtot["chain_ms"]})
    pprof = profile_device(torch, lambda: pserver.forward_batch(x16), card, pfwd_ms, "forward")
    pprof["kernel_impl"] = "pallas"
    emit(pprof)
    serve_launches = launches["deform_attn_fwd"]
    del server, model, pserver, pmodel, servers, x16
    torch.cuda.empty_cache()

    # ---- 8. train: the main path, counts set to 0 just before ----------------
    mark("8. train")
    cfg_train = no_warmup(mc)
    torch.manual_seed(SEED)
    model = build_model(mc, device=dev)
    state = create_train_state(model, cfg_train)
    step = make_train_step(model, aux_weight=mc.aux_loss_weight,
                           ignore_index=cfg_train.data.ignore_index,
                           num_classes=mc.num_classes, compute_dtype=torch.bfloat16)
    b16 = seg_batch(TRAIN_BATCH, SEED + 5, dev)
    torch.cuda.synchronize()
    da.deform_attn.launches = da.deform_attn_bwd.launches = 0
    t0 = time.perf_counter()
    mets = [step(state, b16)[1] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {"deform_attn_fwd": da.deform_attn.launches,
                      "deform_attn_bwd": da.deform_attn_bwd.launches}
    losses = [m["loss"].item() for m in mets]
    gnorms = [m["grad_norm"].item() for m in mets]
    emit({"phase": "train", "card": card, "preset": TRAIN_PRESET, "dtype": "bfloat16",
          "batch": TRAIN_BATCH, "img": IMG, "steps": TRAIN_STEPS,
          "drop_path_rate": mc.backbone.drop_path_rate,
          "dropout": mc.decode_head.kwargs.get("dropout_ratio", 0.1), "warmup_iters": 0,
          "lr": state.schedule(0), "loss_step1": losses[0], f"loss_step{TRAIN_STEPS}": losses[-1],
          "losses": losses, "grad_norms": gnorms,
          "update_ratios": [m["update_ratio"].item() for m in mets],
          "launches": train_launches,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in train_launches.items()},
          "wall_s": train_s})
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train: non-finite loss or grad norm: {losses} {gnorms}")
    for name, n in train_launches.items():
        check(n == n_d * TRAIN_STEPS, f"train: {n} {name} launches, want {n_d * TRAIN_STEPS}")

    # train_pallas: the preset with kernel_impl='pallas' (its MLP dropout is 0,
    # so the gate holds in training), the same batch, counts set to 0 just before
    pmc = replace(mc, backbone=replace(mc.backbone, kernel_impl="pallas"))
    torch.manual_seed(SEED)
    pmodel = build_model(pmc, device=dev)
    pstate = create_train_state(pmodel, no_warmup(pmc))
    pstep = make_train_step(pmodel, aux_weight=mc.aux_loss_weight,
                            ignore_index=cfg_train.data.ignore_index,
                            num_classes=mc.num_classes, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    da.deform_attn.launches = da.deform_attn_bwd.launches = xb.x_block_fwd.launches = 0
    t0 = time.perf_counter()
    pmets = [pstep(pstate, b16)[1] for _ in range(PALLAS_STEPS)]
    torch.cuda.synchronize()
    ptrain_s = time.perf_counter() - t0
    ptrain_launches = {"x_block_fwd": xb.x_block_fwd.launches,
                       "deform_attn_fwd": da.deform_attn.launches,
                       "deform_attn_bwd": da.deform_attn_bwd.launches}
    plosses = [m["loss"].item() for m in pmets]
    pgnorms = [m["grad_norm"].item() for m in pmets]
    emit({"phase": "train_pallas", "card": card, "preset": TRAIN_PRESET, "kernel_impl": "pallas",
          "dtype": "bfloat16", "batch": TRAIN_BATCH, "steps": PALLAS_STEPS, "losses": plosses,
          "grad_norms": pgnorms, "launches": ptrain_launches,
          "launches_per_step": {k: v / PALLAS_STEPS for k, v in ptrain_launches.items()},
          "wall_s": ptrain_s})
    check(all(np.isfinite(plosses)) and all(np.isfinite(pgnorms)),
          f"train_pallas: non-finite loss or grad norm: {plosses} {pgnorms}")
    want_p = {"x_block_fwd": n_x * PALLAS_STEPS, "deform_attn_fwd": n_d * PALLAS_STEPS,
              "deform_attn_bwd": n_d * PALLAS_STEPS}
    check(ptrain_launches == want_p, f"train_pallas: launches {ptrain_launches}, want {want_p}")
    del pmets

    # train_crop: one bf16 step at a 544x544 crop (Ns 289 at stage 0), counts
    # set to 0 just before
    torch.manual_seed(SEED)
    cmodel = build_model(mc, device=dev)
    cstate = create_train_state(cmodel, cfg_train)
    cstep = make_train_step(cmodel, aux_weight=mc.aux_loss_weight,
                            ignore_index=cfg_train.data.ignore_index,
                            num_classes=mc.num_classes, compute_dtype=torch.bfloat16)
    crop = seg_batch(CROP_BATCH, SEED + 8, dev, size=CROP)
    torch.cuda.synchronize()
    da.deform_attn.launches = da.deform_attn_bwd.launches = 0
    t0 = time.perf_counter()
    cmet = cstep(cstate, crop)[1]  # not the state: it would keep the model resident
    torch.cuda.synchronize()
    crop_s = time.perf_counter() - t0
    crop_launches = {"deform_attn_fwd": da.deform_attn.launches,
                     "deform_attn_bwd": da.deform_attn_bwd.launches}
    crop_ok = bool(np.isfinite(cmet["loss"].item()) and np.isfinite(cmet["grad_norm"].item()))
    emit({"phase": "train_crop", "card": card, "preset": TRAIN_PRESET, "dtype": "bfloat16",
          "batch": CROP_BATCH, "crop": CROP, "stage0_samples": (CROP // 4 // 8) ** 2,
          "loss": cmet["loss"].item(), "grad_norm": cmet["grad_norm"].item(),
          "launches": crop_launches, "wall_s": crop_s})
    check(crop_ok, f"train_crop: non-finite loss or grad norm {cmet}")
    check(crop_launches == {"deform_attn_fwd": n_d, "deform_attn_bwd": n_d},
          f"train_crop: launches {crop_launches}, want {n_d} each")
    del cmodel, cstate, cstep, crop, cmet

    # train_checkpoint: use_checkpoint=True at batch 16, counts set to 0 just
    # before: every stage's forward runs again in the backward
    kmc = replace(mc, backbone=replace(mc.backbone, use_checkpoint=True))
    torch.manual_seed(SEED)
    kmodel = build_model(kmc, device=dev)
    kstate = create_train_state(kmodel, no_warmup(kmc))
    kstep = make_train_step(kmodel, aux_weight=mc.aux_loss_weight,
                            ignore_index=cfg_train.data.ignore_index,
                            num_classes=mc.num_classes, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    da.deform_attn.launches = da.deform_attn_bwd.launches = 0
    kmets = [kstep(kstate, b16)[1] for _ in range(2)]
    torch.cuda.synchronize()
    ck_launches = {"deform_attn_fwd": da.deform_attn.launches,
                   "deform_attn_bwd": da.deform_attn_bwd.launches}
    klosses = [m["loss"].item() for m in kmets]
    emit({"phase": "train_checkpoint", "card": card, "preset": TRAIN_PRESET,
          "use_checkpoint": True, "dtype": "bfloat16", "batch": TRAIN_BATCH, "steps": 2,
          "losses": klosses, "losses_without": losses[:2], "launches": ck_launches,
          "launches_per_step": {k: v / 2 for k, v in ck_launches.items()}})
    check(all(np.isfinite(klosses)), f"train_checkpoint: non-finite loss {klosses}")
    want_ck = {"deform_attn_fwd": 2 * n_d * 2, "deform_attn_bwd": n_d * 2}
    check(ck_launches == want_ck, f"train_checkpoint: launches {ck_launches}, want {want_ck}")
    # its time and peak memory beside the step without it, in turns, with the
    # same models resident
    ck = {"use_checkpoint": (kstep, kstate), "without": (step, state)}
    ck_ms = {name: [] for name in ck}
    ck_peak = {}
    for name in ("without", "use_checkpoint", "use_checkpoint", "without"):
        fn, st = ck[name]
        ck_ms[name].append(timed(lambda: fn(st, b16), TIME_STEPS, warmup=1))
    for name, (fn, st) in ck.items():
        torch.cuda.reset_peak_memory_stats()
        fn(st, b16)
        torch.cuda.synchronize()
        ck_peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "train_time", "card": card, "dtype": "bfloat16", "batch": TRAIN_BATCH,
          "compare": "use_checkpoint vs without, in turns",
          "order": "without ckpt ckpt without", "ms_per_step": ck_ms,
          "img_per_s": {k: [TRAIN_BATCH / v * 1e3 for v in vs] for k, vs in ck_ms.items()},
          "peak_mem_gib": ck_peak})
    del kmodel, kstate, kstep, kmets, ck
    torch.cuda.empty_cache()

    # ---- 9. train times: K2 per stage, the step, its profile ------------------
    mark("9. train times")
    btot = {}
    for s in stages:
        row = k2_stage_time(s, TIME_BATCH)
        add_stage(btot, row)
        emit({"phase": "kernel_time", "card": card, **row})

    step_ms = timed(lambda: step(state, b16), TIME_STEPS, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step(state, b16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prof = profile_device(torch, lambda: step(state, b16), card, step_ms, "step", iters=2)
    k12 = sum(ms for name, ms in prof.get("kernels_ms", {}).items())
    emit({"phase": "train_time", "card": card, "dtype": "bfloat16", "batch": TRAIN_BATCH,
          "ms_per_step": step_ms, "img_per_s": TRAIN_BATCH / step_ms * 1e3,
          "peak_mem_gib": peak / 2 ** 30, "deform_attn_fwd_ms": totals["ms"],
          "deform_attn_bwd_ms": btot["ms"],
          "k1_k2_share_profiled": k12 / prof["device_ms_per_step"] if "kernels_ms" in prof else None})
    emit(prof)

    # the step with 'auto' and 'pallas' in turns (auto, pallas, pallas, auto)
    steps = {"auto": (step, state), "pallas": (pstep, pstate)}
    sms = {"auto": [], "pallas": []}
    speak = {}
    for impl in ("auto", "pallas", "pallas", "auto"):
        fn, st = steps[impl]
        sms[impl].append(timed(lambda: fn(st, b16), TIME_STEPS, warmup=1))
    for impl, (fn, st) in steps.items():
        torch.cuda.reset_peak_memory_stats()
        fn(st, b16)
        torch.cuda.synchronize()
        speak[impl] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "train_time", "card": card, "dtype": "bfloat16", "batch": TRAIN_BATCH,
          "compare": "kernel_impl auto vs pallas, in turns", "order": "auto pallas pallas auto",
          "ms_per_step": sms,
          "img_per_s": {k: [TRAIN_BATCH / v * 1e3 for v in vs] for k, vs in sms.items()},
          "peak_mem_gib": speak})

    # ---- 10. eval: ADE20K val to mIoU through the port's test CLI ----------
    mark("10. eval")
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="eval_export_"))
    eval_launches, eval_ckpt = eval_phase(torch, np, card, dev, get_config(PRESET), n_d, work)

    # ---- 10c. exact_eval: exact padded inference, bucket-batched eval ---------
    mark("10c. exact_eval")
    exact_launches = exact_eval_phase(torch, np, card, dev, eval_ckpt, n_d, timed)

    # ---- 10b. export: torch.export artifacts, served without the model code;
    # 17b-d's processes beside it, up to its times --------------------------
    mark("10b. export, 17b-d's processes beside it")
    del steps, step, state, model, pstep, pstate, pmodel, b16
    torch.cuda.empty_cache()
    refs = Path(tempfile.mkdtemp(prefix="axis_refs_"))
    axis_run = axis_start(torch, np, refs)
    try:
        export_launches = export_phase(torch, np, card, dev, eval_ckpt, work, n_d, n_x, timed,
                                       settle=lambda: axis_wait(axis_run))
        shutil.rmtree(work, ignore_errors=True)
        # ---- 17b-d. model_axis, spatial_axis, full_mesh: the mesh's axes -------
        mark("17b-d. model_axis, spatial_axis, full_mesh")
        axis_launches, spatial_launches, full_launches = axis_phases(
            torch, card, axis_run, n_d, n_x)
    finally:
        axis_kill(axis_run)
        shutil.rmtree(refs, ignore_errors=True)

    # ---- 11. train_loop: the seg trainer through the train CLI --------------
    mark("11. train_loop")
    loop_launches = train_loop_phase(torch, np, card, n_d, n_x)

    # ---- 12-16. the classifier slice ----------------------------------------
    mark("12-16. the classifier slice")
    cls_launches = cls_phases(torch, np, card, dev, dict(
        timed=timed, k1_inputs=k1_inputs, k1_stage_time=k1_stage_time,
        k2_stage_time=k2_stage_time, add_stage=add_stage))

    # ---- 17. scale_out: the step over processes --------------------------------
    mark("17. scale_out")
    scale_launches = scale_out_phase(torch, np, card, dev, n_d, timed, scale_run)

    # ---- 18. pe_modes: the other position-bias modes --------------------------
    mark("18. pe_modes")
    pe_launches = pe_modes_phase(torch, np, card, dev, timed)

    # ---- kernels line, card, verdict ----------------------------------------
    def line(kernel, n, err, tot):
        return dict(kernel, launches=n, max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                    bound_ms=tot["bound_ms"],
                    bound_by="operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
                    library_ms=tot["library_ms"])

    k1 = line(KERNELS[0], train_launches["deform_attn_fwd"], max_err, totals)
    k1["launches_by_path"] = {"serve": serve_launches, "train": train_launches["deform_attn_fwd"],
                              "eval": eval_launches, **exact_launches,
                              "export": export_launches["deform_attn_fwd"],
                              "train_loop": loop_launches["deform_attn_fwd"],
                              **cls_launches["deform_attn_fwd"],
                              "scale_out_rank0": scale_launches["deform_attn_fwd"],
                              "model_axis_rank0": axis_launches["deform_attn_fwd"],
                              "model_axis_modes_rank0": axis_launches["modes"]["deform_attn_fwd"],
                              "spatial_rank0": spatial_launches["deform_attn_fwd"],
                              "full_mesh_rank0": full_launches["deform_attn_fwd"],
                              "pe_modes_mixed_serve": pe_launches["serve"],
                              "pe_modes_mixed_train": pe_launches["train"]["deform_attn_fwd"]}
    k1.update(lse_max_abs_err=max_lse_err, warps_per_sm=k1_warps, mma_instructions=k1_mma,
              attribution_ms={v: totals[f"{v}_ms"] for v in K1_VARIANTS})
    k2 = line(KERNELS[1], train_launches["deform_attn_bwd"], max_err_bwd, btot)
    k2.update(max_rel_err=max_rel_bwd, warps_per_sm=k2_warps, mma_instructions=k2_mma,
              attribution_ms={v: btot[f"{v}_ms"] for v in K2_VARIANTS},
              launches_by_path={"train": train_launches["deform_attn_bwd"],
                                "train_crop": crop_launches["deform_attn_bwd"],
                                "train_checkpoint": ck_launches["deform_attn_bwd"],
                                "train_loop": loop_launches["deform_attn_bwd"],
                                **cls_launches["deform_attn_bwd"],
                                "scale_out_rank0": scale_launches["deform_attn_bwd"],
                                "model_axis_rank0": axis_launches["deform_attn_bwd"],
                                "model_axis_modes_rank0":
                                    axis_launches["modes"]["deform_attn_bwd"],
                                "spatial_rank0": spatial_launches["deform_attn_bwd"],
                                "full_mesh_rank0": full_launches["deform_attn_bwd"],
                                "pe_modes_mixed_train": pe_launches["train"]["deform_attn_bwd"]})
    k3 = line(KERNELS[2], pserve_launches["x_block_fwd"], max_err_xb, dict(xtot, library_ms=None))
    k3.update(max_rel_err=max_rel_xb, chain_ms=xtot["chain_ms"], mma_instructions=k3_mma,
              warps_per_sm=k3_warps,
              yardstick="no one PyTorch call computes the block: chain_ms is the unfused "
                        "stock-op chain the model runs without K3, per forward",
              launches_by_path={"serve": pserve_launches["x_block_fwd"],
                                "predict": predict_launches,
                                "export": export_launches["x_block_fwd"],
                                "train": ptrain_launches["x_block_fwd"],
                                "train_loop": loop_launches["x_block_fwd"],
                                "model_axis_rank0": axis_launches["x_block_fwd"],
                                "spatial_rank0": spatial_launches["x_block_fwd"],
                                "full_mesh_rank0": full_launches["x_block_fwd"],
                                **cls_launches["x_block_fwd"]})
    # K1-v1 (the JAX package's fused_deform_attention_fwd) is K1's function
    # without padded queries: the port runs it as K1's launch with hn = wn = 0,
    # which is every launch above
    k1v1 = dict(k1, name="deform_attn_fwd (v1: hn = wn = 0)",
                replaces="dat_segmentation_tpu/ops/pallas/deform_attn.py:811")
    emit({"kernels": [k1, k1v1, k2, k3]})
    print(f"chip_smoke: wall {time.perf_counter() - T_START:.1f} s", file=sys.stderr, flush=True)
    if failures:
        print("chip_smoke: failed: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


KERNEL_NAMES = tuple(k["name"] for k in KERNELS)  # each a part of its CUDA kernels' names


def eval_phase(torch, np, card, dev, full_cfg, n_d, work):
    """10. eval: ADE20K val to mIoU on the card through the port's test CLI,
    on the fixture ``tests/data/ade20k_tiny`` (six images, 512x512 to
    512x768, masks labelled 0-150), with the flagship at full width and
    depth, random weights from the seed, bf16. Returns K1's launches in
    the batch-1 CLI run (counts set to 0 just before) and the mmseg-schema
    ``.pth`` it wrote under ``work``."""
    import hashlib

    import PIL

    from dat_segmentation_tpu_torch import SegInferencer, build_model
    from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
    from dat_segmentation_tpu_torch.data.image_io import imread_gray, imread_rgb
    from dat_segmentation_tpu_torch.eval import evaluate as ev
    from dat_segmentation_tpu_torch.eval.inference import MS_RATIOS
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.ops.interpolate import resize_bilinear
    from dat_segmentation_tpu_torch.tools import test as test_cli
    from dat_segmentation_tpu_torch.tools.reference_schema import save_reference
    from dat_segmentation_tpu_torch.train.checkpoint import load_pretrained, merge_pretrained

    root = Path(__file__).resolve().parent / EVAL_DATA
    digests = json.loads((root / "cv2_digests.json").read_text())
    ds = ADE20KDataset(root, "val")
    n_img = len(ds)
    cfg, scale = full_cfg.model, tuple(full_cfg.data.img_scale)

    def resized(h, w):  # keep-ratio fit to scale, as SegInferencer.tta_inputs
        f = min(scale[0] / w, scale[1] / h)
        return int(h * f + 0.5), int(w * f + 0.5)
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731

    # -- decode: the port's readers against cv2's decodes ----------------------
    masks_equal = {n: sha(imread_gray(root / "annotations" / "validation" / n)) == d["sha256"]
                   for n, d in digests["masks"].items()}
    images_equal = {n: sha(imread_rgb(root / "images" / "validation" / n)) == d["sha256"]
                    for n, d in digests["images"].items()}
    dec = {}
    for path in sorted((root / "decode").glob("*.jpg")):
        got = imread_rgb(path).astype(np.int16)
        ref = np.load(path.with_suffix(".npz"))["rgb"].astype(np.int16)
        diff = np.abs(got - ref) if got.shape == ref.shape else np.full(ref.shape, 255)
        dec[path.name] = {"max_abs_diff": int(diff.max()), "share_differing": float((diff > 0).mean())}
    jpeg_s = png_s = 0.0
    for i in range(n_img):
        t0 = time.perf_counter()
        imread_rgb(ds.images[i])
        t1 = time.perf_counter()
        imread_gray(ds.masks[i])
        jpeg_s, png_s = jpeg_s + t1 - t0, png_s + time.perf_counter() - t1
    decoder = f"Pillow {PIL.__version__}"
    emit({"phase": "eval", "card": card, "step": "decode", "jpeg_decoder": decoder,
          "png_decoder": "image_io.read_png_gray8 (zlib)", "masks_equal_cv2": masks_equal,
          "images_equal_cv2": images_equal, "decode_vs_cv2": dec,
          "tol_max_abs_diff": DECODE_MAX_DIFF, "tol_share_differing": DECODE_MAX_SHARE,
          "jpeg_ms_per_img": jpeg_s / n_img * 1e3, "png_ms_per_img": png_s / n_img * 1e3})
    check(all(masks_equal.values()), f"eval decode: masks differ from cv2's: {masks_equal}")
    for name, d in dec.items():
        check(d["max_abs_diff"] <= DECODE_MAX_DIFF and d["share_differing"] <= DECODE_MAX_SHARE,
              f"eval decode {name}: {d} beyond ({DECODE_MAX_DIFF}, {DECODE_MAX_SHARE})")

    # -- load: a mmseg-schema .pth of the flagship, loaded back ------------
    torch.manual_seed(SEED)
    model = build_model(cfg, device=dev)
    ckpt = save_reference(model, cfg, work / f"{PRESET}_mmseg.pth", mmseg=True)
    torch.manual_seed(SEED + 5)
    fresh = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    _, report = merge_pretrained(fresh, load_pretrained(str(ckpt), cfg), verbose=False,
                                 return_report=True)
    load_s = time.perf_counter() - t0
    want = model.state_dict()
    unequal = [k for k, v in fresh.state_dict().items() if not torch.equal(v, want[k])]
    emit({"phase": "eval", "card": card, "step": "load", "preset": PRESET,
          "schema": "mmseg", "pth_mib": ckpt.stat().st_size / 2 ** 20,
          "tensors": len(want), "missing": len(report["missing"]),
          "unexpected": len(report["unexpected"]), "mismatched": len(report["mismatched"]),
          "tensors_unequal": len(unequal), "load_s": load_s})
    check(not any(report.values()), f"eval load: report not empty: {report}")
    check(not unequal, f"eval load: {len(unequal)} tensors differ, e.g. {unequal[:3]}")
    del fresh

    # -- evaluate through the CLI: batch 1, batch 4, one image with TTA ----
    def forwards(batch):
        """Forwards of a batched whole-mode eval: runs of consecutive
        images whose resized inputs share a shape, ``batch`` at most."""
        shapes = [resized(*ds.load_raw(i)[1].shape) for i in range(n_img)]
        n, run = 0, 0
        for i, s in enumerate(shapes):
            run = 1 if i == 0 or s != shapes[i - 1] or run == batch else run + 1
            n += run == 1
        return n

    results, k1 = {}, {}
    pngs = {"show": work / "show", "format": work / "format"}
    for name, extra, n_fwd in (("batch1", ["--batch-size", "1", "--show-dir", str(pngs["show"]),
                                           "--format-dir", str(pngs["format"])], n_img),
                               ("batch4", ["--batch-size", "4"], forwards(4)),
                               ("aug_test", ["--batch-size", "1", "--aug-test",
                                             "--max-images", "1"], 2 * len(MS_RATIOS))):
        out = work / f"{name}.json"
        da.deform_attn.launches = 0
        t0 = time.perf_counter()
        res = test_cli.main([PRESET, str(ckpt), "--data-root", str(root), "--mode", "whole",
                             "--out", str(out), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1[name] = da.deform_attn.launches
        results[name] = res
        n_want = 1 if name == "aug_test" else n_img
        ok = bool(json.loads(out.read_text()) == json.loads(json.dumps(res))
                  and sum(res["union"]) >= sum(res["inter"]) >= 0 < sum(res["union"])
                  and 0.0 <= res["aAcc"] <= 1.0 and np.isfinite(res["mIoU"]))
        emit({"phase": "eval", "card": card, "step": f"cli {name}", "dtype": "bfloat16",
              "args": extra, "img_scale": list(scale), "num_images": res["num_images"],
              "forwards": n_fwd, "k1_launches": k1[name], "k1_launches_per_forward":
              k1[name] / n_fwd, "mIoU": res["mIoU"], "aAcc": res["aAcc"],
              "classes_present": sum(u > 0 for u in res["union"]), "result_ok": ok,
              "wall_s_with_model_build_and_load": wall})
        check(res["num_images"] == n_want, f"eval {name}: {res['num_images']} images")
        check(k1[name] == n_d * n_fwd, f"eval {name}: {k1[name]} K1 launches, "
                                       f"want {n_d} a forward x {n_fwd}")
        check(ok, f"eval {name}: result dict inconsistent")
    # --show-dir/--format-dir of the batch-1 run: a PNG an image, at its size
    from dat_segmentation_tpu_torch.data.image_io import read_png_gray8

    fmt = {p.stem: read_png_gray8(p.read_bytes(), str(p)) for p in pngs["format"].glob("*.png")}
    shapes_ok = all(fmt.get(Path(m).stem) is not None and fmt[Path(m).stem].shape ==
                    ds.load_raw(i)[1].shape for i, m in enumerate(ds.images))
    emit({"phase": "eval", "card": card, "step": "cli batch1 pngs",
          "show_pngs": len(list(pngs["show"].glob("*.png"))), "format_pngs": len(fmt),
          "format_shapes_ok": shapes_ok,
          "format_labels": [int(min(a.min() for a in fmt.values())),
                            int(max(a.max() for a in fmt.values()))]})
    check(len(fmt) == n_img == len(list(pngs["show"].glob("*.png"))) and shapes_ok
          and all(1 <= a.min() and a.max() <= cfg.num_classes for a in fmt.values()),
          "eval cli --show-dir/--format-dir: PNGs missing or of the wrong size or labels")
    pixels = sum(np.prod(ds.load_raw(i)[1].shape) for i in range(n_img))
    d_inter = int(np.abs(np.subtract(results["batch4"]["inter"],
                                     results["batch1"]["inter"])).sum())
    d_union = int(np.abs(np.subtract(results["batch4"]["union"],
                                     results["batch1"]["union"])).sum())
    emit({"phase": "eval", "card": card, "step": "batch4 vs batch1", "dtype": "bfloat16",
          "pixels": int(pixels), "sum_abs_d_inter": d_inter, "sum_abs_d_union": d_union,
          "tol_share": EVAL_BATCH_SHARE})
    check(d_inter <= EVAL_BATCH_SHARE * pixels and d_union <= 2 * EVAL_BATCH_SHARE * pixels,
          f"eval batch4 vs batch1: counts differ by {d_inter}, {d_union} of {pixels} pixels")

    # -- card vs CPU, float32, TF32 off: per pixel -----------------------------
    preds, secs = {}, {}
    infs = {name: SegInferencer(model, num_classes=cfg.num_classes, compute_dtype=torch.float32,
                                device=d) for name, d in (("card", dev), ("cpu", "cpu"))}
    for d, inf in infs.items():
        preds[d] = {}
        t0 = time.perf_counter()
        ev.evaluate_dataset(inf, ds, img_scale=scale, verbose=False,
                            on_pred=lambda i, p, d=d: preds[d].__setitem__(i, p))
        secs[d] = time.perf_counter() - t0
    flipped, worst_gap = 0, 0.0
    for i in range(n_img):
        differ = preds["card"][i] != preds["cpu"][i]
        if differ.any():
            raw, gt = ds.load_raw(i)
            (inp, _), = infs["cpu"].tta_inputs(raw, img_scale=scale)
            with torch.inference_mode():
                lg = resize_bilinear(torch.from_numpy(infs["cpu"].logits(inp))[None],
                                     gt.shape)[0]
                top2 = lg.topk(2, dim=-1).values
            gap = (top2[..., 0] - top2[..., 1]).numpy()[differ]
            worst_gap = max(worst_gap, float(gap.max()))
            flipped += int(differ.sum())
    emit({"phase": "eval", "card": card, "step": "card vs cpu", "dtype": "float32",
          "tf32": False, "pixels": int(pixels), "pixels_differing": flipped,
          "share_differing": flipped / pixels, "max_top2_logit_gap_at_differing": worst_gap,
          "tol_gap": EVAL_F32_TIE, "tol_share": EVAL_F32_SHARE,
          "card_s": secs["card"], "cpu_s": secs["cpu"]})
    check(flipped <= EVAL_F32_SHARE * pixels and worst_gap <= EVAL_F32_TIE,
          f"eval card vs cpu: {flipped} pixels differ, top-2 gap up to {worst_gap}")
    del infs

    # -- time: bf16 eval in turns, and where batch 1's wall goes (its last run) --
    server = SegInferencer(model, num_classes=cfg.num_classes, device=dev)
    del model
    spent = {"decode": 0.0, "predict": 0.0, "iou_update": 0.0}  # decode: load_raw, JPEG and PNG

    def timed_attr(obj, name, key):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    class TimedIoU(ev.StreamingIoU):
        def update(self, *a, **k):
            t0 = time.perf_counter()
            super().update(*a, **k)
            spent["iou_update"] += time.perf_counter() - t0

    walls, plain_iou = {1: [], 4: []}, ev.StreamingIoU
    for batch in (1, 4, 4, 1) * 3:  # six images take about 0.3 s: three rounds
        for key in spent:
            spent[key] = 0.0
        tds = ADE20KDataset(root, "val")
        tds.load_raw = timed_attr(tds, "load_raw", "decode")
        server.predict = timed_attr(server, "predict", "predict")
        ev.StreamingIoU = TimedIoU
        try:
            t0 = time.perf_counter()
            ev.evaluate_dataset(server, tds, img_scale=scale, batch_size=batch, verbose=False)
            walls[batch].append(time.perf_counter() - t0)
        finally:
            ev.StreamingIoU = plain_iou
            del server.predict
        if batch == 1:
            split = {k: v / walls[1][-1] for k, v in spent.items()}
    emit({"phase": "eval", "card": card, "step": "time", "dtype": "bfloat16",
          "images": n_img, "order": "(1 4 4 1) x 3", "wall_s": {str(k): v for k, v in walls.items()},
          "img_per_s": {str(k): [n_img / w for w in v] for k, v in walls.items()},
          "batch1_wall_share": split, "jpeg_decoder": decoder})
    emit(profile_device(torch, lambda: ev.evaluate_dataset(server, ds, img_scale=scale,
                                                           verbose=False),
                        card, min(walls[1]) * 1e3, "eval_pass"))
    return k1["batch1"], ckpt


def exact_eval_phase(torch, np, card, dev, ckpt, n_d, timed):
    """10c. exact_eval: exact padded inference and the bucket-batched eval
    on the card, the flagship at full width and depth with random weights
    from the seed. (a) float32, TF32 off: the exact padded forward of
    ``EXACT_SHAPES`` in one bucket against each image's true-shape forward
    (K1's), gated at ``EXACT_TOL``, with 0 K1 launches in the exact one and
    n_d an image in the true-shape ones; (b) bf16: the two forwards' argmax
    agreement on the stride-4 grid, reported; (c) the plain padded forward
    (``exact=False``) in float32 and bf16: each K1 launch against K1's plain
    version on its inputs (max |err| / max |plain|, gated at TOL_F32 and
    TOL_BF16); (d) ``tools/test.py --pad-bucket 32`` and ``--pad-bucket 32
    --no-exact`` on the fixture (counts set to 0 just before each: K1 runs
    in the forwards whose inputs all fill the bucket, the exact ones run the
    composite), then the bucketed exact eval against the true-shape eval
    (``evaluate_dataset``, batch 4, bucket 32 against 1) in bf16: counts
    within EVAL_BATCH_SHARE of the pixels, img/s in turns and each one's
    device busy share; the exact forward's ms a batch beside the plain
    padded one's. Returns the CLI runs' K1 launches."""
    import torch.nn.functional as F

    from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
    from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
    from dat_segmentation_tpu_torch.eval import evaluate as ev
    from dat_segmentation_tpu_torch.eval.inference import round_up
    from dat_segmentation_tpu_torch.models import deformable_attention as dattn
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.tools import test as test_cli

    t_phase = time.perf_counter()
    marks = [t_phase]

    def lap():  # seconds since the last step's line
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    full = get_config(PRESET)
    cfg, scale = full.model, tuple(full.data.img_scale)
    torch.manual_seed(SEED)
    model = build_model(cfg, device=dev).eval()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    imgs = [torch.randn(h, w, 3, generator=gen, device=dev) for h, w in EXACT_SHAPES]
    bucket_hw = tuple(round_up(max(s[d] for s in EXACT_SHAPES), EXACT_BUCKET) for d in (0, 1))
    infs = {dt: {ex: SegInferencer(model, num_classes=cfg.num_classes, compute_dtype=dt,
                                   bucket=EXACT_BUCKET, exact=ex, device=dev)
                 for ex in (True, False)} for dt in (torch.float32, torch.bfloat16)}
    x, valid = infs[torch.float32][True]._padded(imgs, bucket_hw)

    # -- (a) float32: the exact padded forward against each true shape ---------
    ext4 = [infs[torch.float32][True]._ext4(s) for s in EXACT_SHAPES]
    outs = {}
    for dt, key in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        inf = infs[dt][True]
        da.deform_attn.launches = 0
        exact = inf.forward_batch(x, valid_hw=valid)
        torch.cuda.synchronize()
        k1_exact = da.deform_attn.launches
        true = [inf.forward_batch(img[None])[0] for img in imgs]
        torch.cuda.synchronize()
        outs[key] = (exact, true, k1_exact, da.deform_attn.launches - k1_exact)
    exact, true, k1_exact, k1_true = outs["float32"]
    diffs = [(exact[i, :eh, :ew] - t).abs().max().item() if t.shape[:2] == (eh, ew) else
             float("inf") for i, ((eh, ew), t) in enumerate(zip(ext4, true))]
    finite = bool(torch.isfinite(exact).all()) and all(bool(torch.isfinite(t).all()) for t in true)
    emit({"phase": "exact_eval", "card": card, "step": "float32 exact vs true shape",
          "preset": PRESET, "tf32": False, "shapes": [list(s) for s in EXACT_SHAPES],
          "bucket": list(bucket_hw), "logits": list(exact.shape), "stride4_extents": ext4,
          "max_abs_diff": diffs, "tol": EXACT_TOL,
          "logit_max_abs": max(t.abs().max().item() for t in true),
          "k1_launches_exact": k1_exact, "k1_launches_true_shape": k1_true, "finite": finite,
          "s": lap()})
    check(finite and max(diffs) <= EXACT_TOL,
          f"exact_eval f32: exact padded vs true-shape logits differ by {max(diffs)}")
    check(k1_exact == 0 and k1_true == n_d * len(imgs),
          f"exact_eval f32: K1 launches exact {k1_exact} (want 0), true-shape {k1_true} "
          f"(want {n_d * len(imgs)})")

    # -- (b) bf16: argmax agreement of the same pair ----------------------------
    exact, true, k1_exact, k1_true = outs["bfloat16"]
    agree = [(exact[i, :eh, :ew].argmax(-1) == t.argmax(-1)).float().mean().item()
             for i, ((eh, ew), t) in enumerate(zip(ext4, true))]
    emit({"phase": "exact_eval", "card": card, "step": "bf16 exact vs true shape",
          "argmax_agreement": agree, "max_abs_diff": [
              (exact[i, :eh, :ew] - t).abs().max().item()
              for i, ((eh, ew), t) in enumerate(zip(ext4, true))],
          "k1_launches_exact": k1_exact, "k1_launches_true_shape": k1_true, "s": lap()})
    check(k1_exact == 0 and k1_true == n_d * len(imgs), f"exact_eval bf16: K1 launches "
                                                         f"{k1_exact}, {k1_true}")
    del outs, exact, true

    # -- (c) the plain padded forward: each K1 launch against its plain version --
    real_attn = dattn.deform_attn
    seen = []

    def attn(q, *a, **k):
        out = real_attn(q, *a, **k)
        with torch.no_grad():
            ref = da.deform_attn_reference(q, *a, **k)
        err = (out.float() - ref.float()).abs().max().item()
        seen.append({"q": list(q.shape), "Ns": a[0].shape[1], "max_abs_err": err,
                     "rel_err": err / max(ref.float().abs().max().item(), 1e-12)})
        return out

    plain_k1 = {}
    dattn.deform_attn = attn
    try:
        for dt, key, tol in ((torch.float32, "float32", TOL_F32),
                             (torch.bfloat16, "bfloat16", TOL_BF16)):
            seen.clear()
            da.deform_attn.launches = 0
            infs[dt][False].forward_batch(x, valid_hw=valid)  # exact=False: valid_hw unused
            torch.cuda.synchronize()
            worst = max(r["rel_err"] for r in seen) if seen else float("inf")
            plain_k1[key] = {"launches": da.deform_attn.launches,
                             "max_abs_err": max((r["max_abs_err"] for r in seen), default=None),
                             "max_rel_err": worst}
            emit({"phase": "exact_eval", "card": card, "step": f"no_exact K1 vs plain {key}",
                  "launches": da.deform_attn.launches, "tol_rel": tol,
                  "per_launch": seen[:4] + seen[-1:], "max_rel_err": worst,
                  "max_abs_err": plain_k1[key]["max_abs_err"], "s": lap()})
            check(da.deform_attn.launches == n_d == len(seen) and worst <= tol,
                  f"exact_eval no_exact {key}: {da.deform_attn.launches} K1 launches "
                  f"(want {n_d}), max rel err {worst} > {tol}")
    finally:
        dattn.deform_attn = real_attn
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # -- (d) the CLI with --pad-bucket 32 [--no-exact], then the timed passes ----
    root = Path(__file__).resolve().parent / EVAL_DATA
    ds = ADE20KDataset(root, "val")
    n_img = len(ds)

    def resized(h, w):  # keep-ratio fit to scale, as SegInferencer.tta_inputs
        f = min(scale[0] / w, scale[1] / h)
        return int(h * f + 0.5), int(w * f + 0.5)

    keys = {}
    for i in range(n_img):  # the bucket batcher's keys: padded shape -> true shapes
        hw = resized(*ds.load_raw(i)[1].shape)
        keys.setdefault(tuple(round_up(v, EXACT_BUCKET) for v in hw), []).append(hw)
    full_fwd = sum(-(-len(v) // EXACT_BATCH) for k, v in keys.items() if all(s == k for s in v))
    fwds = sum(-(-len(v) // EXACT_BATCH) for v in keys.values())
    cli = {}
    for name, extra, want in (("exact_eval_cli", [], full_fwd * n_d),
                              ("exact_eval_cli_no_exact", ["--no-exact"], fwds * n_d)):
        da.deform_attn.launches = 0
        res = test_cli.main([PRESET, str(ckpt), "--data-root", str(root), "--mode", "whole",
                             "--pad-bucket", str(EXACT_BUCKET), "--batch-size",
                             str(EXACT_BATCH), *extra])
        torch.cuda.synchronize()
        cli[name] = da.deform_attn.launches
        emit({"phase": "exact_eval", "card": card, "step": f"cli --pad-bucket {EXACT_BUCKET}"
              + (" --no-exact" if extra else ""), "buckets": {f"{k[0]}x{k[1]}": [list(s) for s in v]
                                                             for k, v in keys.items()},
              "forwards": fwds, "k1_launches": cli[name], "want": want,
              "num_images": res["num_images"], "mIoU": res["mIoU"], "aAcc": res["aAcc"],
              "s": lap()})
        check(cli[name] == want and res["num_images"] == n_img and np.isfinite(res["mIoU"]),
              f"exact_eval {name}: {cli[name]} K1 launches, want {want}")

    server = {b: SegInferencer(model, num_classes=cfg.num_classes, bucket=b, device=dev)
              for b in (1, EXACT_BUCKET)}
    del model
    results, walls = {}, {1: [], EXACT_BUCKET: []}
    routes = {1: [], EXACT_BUCKET: []}
    peak = {1: 0, EXACT_BUCKET: 0}
    for b in (1, EXACT_BUCKET, EXACT_BUCKET, 1) * 2:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = Counter(server[b]._graphs.routes)
        t0 = time.perf_counter()
        results[b] = ev.evaluate_dataset(server[b], ds, img_scale=scale, batch_size=EXACT_BATCH,
                                         verbose=False)
        torch.cuda.synchronize()
        walls[b].append(time.perf_counter() - t0)
        routes[b].append(dict(Counter(server[b]._graphs.routes) - before))
        peak[b] = max(peak[b], torch.cuda.max_memory_allocated())
    pixels = int(sum(np.prod(ds.load_raw(i)[1].shape) for i in range(n_img)))
    d_inter = int(np.abs(np.subtract(results[EXACT_BUCKET]["inter"], results[1]["inter"])).sum())
    d_union = int(np.abs(np.subtract(results[EXACT_BUCKET]["union"], results[1]["union"])).sum())
    # one profiled pass each: the profiler's host work on a pass's thousands
    # of ops is most of the phase's time at its default three
    profiles = {b: profile_device(torch, lambda b=b: ev.evaluate_dataset(
        server[b], ds, img_scale=scale, batch_size=EXACT_BATCH, verbose=False), card,
        min(walls[b]) * 1e3, "eval_pass", iters=1) for b in server}
    emit({"phase": "exact_eval", "card": card, "step": "eval time", "dtype": "bfloat16",
          "images": n_img, "batch": EXACT_BATCH, "order": "(1 32 32 1) x 2",
          "compare": "bucket 32 (exact padded, fixed batch of 4) vs bucket 1 (true shape, "
                     "consecutive images of one shape batched)",
          "wall_s": {str(b): v for b, v in walls.items()},
          "img_per_s": {str(b): [n_img / w for w in v] for b, v in walls.items()},
          "routes_per_pass": {str(b): v for b, v in routes.items()},
          "graphs": {str(b): len(server[b]._graphs.graphs) for b in server},
          "keys": {str(b): len(server[b]._graphs.seen) for b in server},
          "peak_gib": {str(b): v / 2 ** 30 for b, v in peak.items()},
          "peak_note": "each pass's peak, both inferencers and their graphs alive",
          "device_busy_share": {str(b): p.get("device_busy_share") for b, p in profiles.items()},
          "device_ms_per_pass": {str(b): p.get("device_ms_per_eval_pass")
                                 for b, p in profiles.items()},
          "pixels": pixels, "sum_abs_d_inter": d_inter, "sum_abs_d_union": d_union,
          "tol_share": EVAL_BATCH_SHARE, "s": lap()})
    for b, p in profiles.items():
        emit(dict(p, compare=f"eval pass at bucket {b}"))
    check(d_inter <= EVAL_BATCH_SHARE * pixels and d_union <= 2 * EVAL_BATCH_SHARE * pixels,
          f"exact_eval bucket 32 vs 1: counts differ by {d_inter}, {d_union} of {pixels} pixels")

    fwd = {"exact": lambda: server[EXACT_BUCKET].forward_batch(x, valid_hw=valid),
           "plain_padded": lambda: server[EXACT_BUCKET].forward_batch(x)}
    ms = {k: [] for k in fwd}
    for k in ("exact", "plain_padded", "plain_padded", "exact"):
        with torch.inference_mode():
            ms[k].append(timed(fwd[k], EXACT_TIME_ITERS))
    fprof = {k: profile_device(torch, fn, card, min(ms[k]), "forward", iters=2)
             for k, fn in fwd.items()}
    emit({"phase": "exact_eval", "card": card, "step": "forward time", "dtype": "bfloat16",
          "batch": list(x.shape), "valid_hw": valid.tolist(), "ms_per_batch": ms,
          "device_ms_per_batch": {k: p.get("device_ms_per_forward") for k, p in fprof.items()},
          "device_busy_share": {k: p.get("device_busy_share") for k, p in fprof.items()},
          "k1_ms_per_batch": {k: p.get("kernels_ms", {}).get("deform_attn_fwd")
                              for k, p in fprof.items()},
          "s": lap(), "phase_s": time.perf_counter() - t_phase})
    for k, p in fprof.items():
        emit(dict(p, compare=f"{k} forward, batch {EXACT_BATCH} at {bucket_hw}"))
    del server, infs
    torch.cuda.empty_cache()
    return cli


def export_worker(spec_path: str) -> None:
    """Run by ``export_phase`` in a fresh process whose working directory
    holds a copy of the package without ``_build/``: serve each artifact
    of the spec through ``ServingModel``, importing only
    ``dat_segmentation_tpu_torch.serving`` of the port (its op modules come
    with it), one forward an entry with the kernels' counts set to 0 just
    before and read just after, and ``predict_semseg`` on the raw image;
    arrays to the spec's files, one JSON line to stdout with the modules
    the process imported, where the package came from, whether ``nvcc``
    was found and what ``_build/`` holds afterwards."""
    import numpy as np
    import torch

    from dat_segmentation_tpu_torch.serving import ServingModel

    spec = json.loads(Path(spec_path).read_text())
    cb = sys.modules["dat_segmentation_tpu_torch.ops.cuda_build"]
    da = sys.modules["dat_segmentation_tpu_torch.ops.deform_attn"]
    xb = sys.modules["dat_segmentation_tpu_torch.ops.x_block"]
    try:
        nvcc = cb.nvcc_path()
    except RuntimeError:
        nvcc = None
    out = {"package": str(cb.CSRC.parent), "nvcc": nvcc}
    for key, job in spec["jobs"].items():
        srv = ServingModel.load(job["dir"])
        x = np.load(job["input"])
        t0 = time.perf_counter()
        srv._load_kernels(job["entry"])  # the kernels' libraries: loaded, or built and loaded
        kernels_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv(job["entry"], x)  # loads the entry's graph and runs it
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        da.deform_attn.launches = xb.x_block_fwd.launches = 0
        y = srv(job["entry"], x)
        torch.cuda.synchronize()
        res = {"kernels_s": kernels_s, "first_call_s": first_s,
               "launches": {"deform_attn_fwd": da.deform_attn.launches,
                            "x_block_fwd": xb.x_block_fwd.launches}}
        np.save(job["logits"], y.cpu().numpy())
        if "raw" in job:
            raw = np.load(job["raw"])
            res["map_entry"] = srv._pick_entry(*raw.shape[:2])
            np.save(job["map"], srv.predict_semseg(raw))
        out[key] = res
    out["build_files"] = sorted(p.name for p in cb.BUILD_DIR.glob("*"))  # none if it is absent
    out["modules"] = sorted(m for m in sys.modules if m.startswith("dat_segmentation_tpu"))
    print(json.dumps(out), flush=True)


def fresh_serve(root: Path, spec: dict, env: dict):
    """``export_worker`` on ``spec`` in a fresh process run from ``root``
    (a copy of the package and this script); its stdout's last line, or
    None, and the process."""
    (root / "spec.json").write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.export_worker("
                           f"{str(root / 'spec.json')!r})"], capture_output=True, text=True,
                          cwd=root, env=dict(env, PYTHONPATH=str(root)), timeout=600)
    served = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else None
    return served, proc


def export_phase(torch, np, card, dev, ckpt, work, n_d, n_x, timed, settle=None):
    """10b. export: the flagship through ``tools/export.py --check`` from the
    eval phase's ``.pth`` (bf16, batch 16, entries 512x512 and 512x704, the
    second holding the 512x683 raw image), and with ``--no-portable`` on a
    ``'pallas'`` config (512x512, batch 1, ``--platforms cuda``), each
    carrying its kernels' libraries; each artifact served in two fresh
    processes that import only ``serving`` (``export_worker``, started as
    soon as it is written, while this process exports the next one and
    the classifier: K1's and K3's launches a forward), each from a copy of
    the package without ``_build/``:
    once without the libraries, built at load by nvcc, and once as exported,
    where nvcc cannot be found and nothing may be built (logits and class
    maps bit for bit the first's; the seconds of the kernels' libraries
    (built or loaded) and of the first call, and the artifact's bytes with
    and without ``kernels/``, beside); the logits against
    ``SegInferencer.forward_batch`` and ``predict_semseg`` against the live
    class maps; the classifier exported at 224² (batches 1 and 128) against
    the live ``DatClassifier``; the artifact's and the live model's ms a
    batch of 16, in turns, after ``settle()`` (the work beside this phase
    done: every second before it may have shared the card and the cores).
    Returns the launches of the forwards served without nvcc (portable:
    K1; 'pallas': K3)."""
    import dataclasses
    import os
    import shutil

    from dat_segmentation_tpu_torch import SegInferencer, build_model, get_config
    from dat_segmentation_tpu_torch.ops import cuda_build
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.ops.interpolate import resize_bilinear
    from dat_segmentation_tpu_torch.serving import ServingModel, export_classifier, save_artifact
    from dat_segmentation_tpu_torch.tools import export as export_cli
    from dat_segmentation_tpu_torch.train.checkpoint import load_pretrained, merge_pretrained

    t_phase = time.perf_counter()
    cfg = get_config(PRESET).model
    pcfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                 kernel_impl="pallas"))
    arts = {"portable": work / "art", "pallas": work / "art_pallas"}
    runs = {"portable": ([f"{h}x{w}" for h, w in EXPORT_SHAPES], TIME_BATCH, []),
            "pallas": ([f"{IMG}x{IMG}"], 1, ["--no-portable", "--platforms", "cuda", "--set",
                                             "model.backbone.kernel_impl=pallas"])}
    entry = {key: f"seg_{IMG}x{IMG}_b{b}" for key, (_, b, _) in runs.items()}
    # the fresh processes: each artifact without the model code, from a copy
    # of the package without _build/, in two processes started as soon as
    # the artifact is written (the next export and the classifier's run
    # meanwhile). "built": the artifact without its kernel libraries, whose
    # kernels the loader builds at load (nvcc); "carried": the artifact as
    # exported, where nvcc cannot be found (no directory of PATH holds it,
    # CUDA_HOME an empty directory)
    rng = np.random.RandomState(SEED + 11)
    x16 = rng.randn(TIME_BATCH, IMG, IMG, 3).astype(np.float32)
    inputs = {"portable": x16, "pallas": x16[:1]}
    raw = rng.randint(0, 256, (*PREDICT_HW, 3)).astype(np.uint8)
    np.save(work / "raw.npy", raw)
    pkg = Path(cuda_build.CSRC).parent
    empty = work / "empty_cuda_home"
    empty.mkdir()
    path = [d for d in os.environ.get("PATH", "").split(":") if d and not (Path(d) / "nvcc").exists()]
    envs = {"built": dict(os.environ),
            "carried": dict(os.environ, CUDA_HOME=str(empty), PATH=":".join(path))}
    pool = concurrent.futures.ThreadPoolExecutor(len(envs) * len(runs))
    art_bytes, roots, specs, fresh, t_fresh = {}, {}, {}, {}, None
    for key, (shapes, batch, extra) in runs.items():
        t0 = time.perf_counter()
        device = [] if "--platforms" in extra else ["--device", str(dev)]
        summary = export_cli.main([PRESET, str(ckpt), "--output", str(arts[key]), "--shapes",
                                   ",".join(shapes), "--batch", str(batch), "--check",
                                   *device, *extra])
        want_k = ["dat::deform_attn_fwd"] + (["dat::x_block_fwd"] if key == "pallas" else [])
        emit({"phase": "export", "card": card, "part": f"cli {key}", "preset": PRESET,
              "dtype": "bfloat16", "batch": batch, "args": extra, "entries": summary["entries"],
              "cli_wall_s": time.perf_counter() - t0, "tol_rel": EXPORT_TOL_REL})
        for name, e in summary["entries"].items():
            check(e["kernels"] == want_k, f"export {key} {name}: kernels {e['kernels']}, want {want_k}")
        d = arts[key]
        np.save(work / f"x_{key}.npy", inputs[key])
        meta = json.loads((d / "meta.json").read_text())
        libs = meta.pop("kernel_libraries", [])
        check([lib["op"] for lib in libs] == want_k
              and all(lib["digest"] == cuda_build.digest(lib["source"])
                      and lib["arch"] == cuda_build.ARCH for lib in libs),
              f"export {key}: kernel libraries {libs}, want {want_k} at the installed digests")
        total = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        kernels = sum(f.stat().st_size for f in (d / "kernels").glob("*"))
        art_bytes[key] = {"with_kernels": total, "without_kernels": total - kernels,
                          "kernels": {lib["op"]: lib["bytes"] for lib in libs}}
        bare = work / f"{d.name}_bare"
        shutil.copytree(d, bare, ignore=shutil.ignore_patterns("kernels", "meta.json"),
                        copy_function=os.link)
        (bare / "meta.json").write_text(json.dumps(meta))
        mark(f"10b. export: the fresh processes of {key}")
        t_fresh = t_fresh or time.perf_counter()
        for mode in envs:
            roots[mode, key] = root = work / f"fresh_{mode}_{key}"
            shutil.copytree(pkg, root / pkg.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
            shutil.copy(Path(__file__).resolve(), root / "chip_smoke.py")
            job = {"dir": str(d if mode == "carried" else bare), "entry": entry[key],
                   "input": str(work / f"x_{key}.npy"), "logits": str(root / f"y_{key}.npy")}
            if key == "portable":
                job.update(raw=str(work / "raw.npy"), map=str(root / "map.npy"))
            specs[mode, key] = {"jobs": {key: job}}
            fresh[mode, key] = pool.submit(fresh_serve, root, specs[mode, key], envs[mode])

    # meanwhile, the classifier: batch 1 and the cls phase's batch, 224²
    ccfg = get_config(CLS_PRESET).model
    torch.manual_seed(SEED)
    cmodel = build_model(ccfg, device=dev)
    entries, cls_s = {}, {}
    for b in (1, CLS_BATCH):
        t0 = time.perf_counter()
        entries[f"cls_{CLS_IMG}x{CLS_IMG}_b{b}"] = export_classifier(
            ccfg, cmodel.state_dict(), batch=b, input_size=(CLS_IMG, CLS_IMG), device=dev)
        cls_s[b] = time.perf_counter() - t0
    srv = ServingModel.load(save_artifact(work / "art_cls", entries, task="classifier",
                                          model_cfg=ccfg, num_classes=ccfg.num_classes))
    cast = copy.deepcopy(cmodel).to(dtype=torch.bfloat16).eval()
    for b in (1, CLS_BATCH):
        name = f"cls_{CLS_IMG}x{CLS_IMG}_b{b}"
        xc = torch.from_numpy(rng.randn(b, CLS_IMG, CLS_IMG, 3).astype(np.float32)).to(dev)
        srv(name, xc)  # loads the entry
        da.deform_attn.launches = 0
        got = srv(name, xc)
        k1 = da.deform_attn.launches
        with torch.inference_mode():
            want = cast(xc.to(torch.bfloat16)).float()
        rel = float((got - want).abs().max() / want.abs().max())
        emit({"phase": "export", "card": card, "part": "classifier", "preset": CLS_PRESET,
              "entry": name, "export_s": cls_s[b], "bytes": srv.entries[name]["bytes"],
              "k1_launches_per_forward": k1, "rel_vs_live": rel,
              "bit_equal_live": bool(torch.equal(got, want)), "tol_rel": EXPORT_TOL_REL})
        check(k1 == n_d, f"export classifier {name}: {k1} K1 launches, want {n_d}")
        check(rel <= EXPORT_TOL_REL, f"export classifier {name}: rel {rel} vs the live model")
    del srv, cast, cmodel, entries

    # the live models on the same inputs: the .pth merged into a fresh build
    state = load_pretrained(str(ckpt), cfg)
    lives = {}
    for key, c in (("portable", cfg), ("pallas", pcfg)):
        m = build_model(c, device=dev)
        merge_pretrained(m, state, verbose=False)
        lives[key] = SegInferencer(m, num_classes=cfg.num_classes, device=dev)
        del m
    results = {mk: f.result() for mk, f in fresh.items()}
    pool.shutdown()
    fresh_s = time.perf_counter() - t_fresh
    served = {}  # (mode, artifact) -> the fresh process's line
    for (mode, key), (out, proc) in results.items():
        what = f"export fresh process ({mode} {key})"
        check(proc.returncode == 0, f"{what}: rc {proc.returncode}: {proc.stderr[-2000:]}")
        served[mode, key] = got = out or {}
        modules = got.get("modules", [])
        model_code = [m for m in modules if m.startswith("dat_segmentation_tpu_torch.models")
                      or m.split(".")[0] == "dat_segmentation_tpu"]
        check(bool(modules) and not model_code, f"{what} imported {model_code}")
        check(got.get("package", "").startswith(str(roots[mode, key].resolve())),
              f"{what}: the package from {got.get('package')}")
        if mode == "built":
            check(got.get("nvcc") is not None and bool(got.get("build_files")),
                  f"{what}: nvcc {got.get('nvcc')}, built {got.get('build_files')}")
        else:
            check(got.get("nvcc") is None and got.get("build_files") == [],
                  f"{what}: nvcc {got.get('nvcc')}, _build/ holds {got.get('build_files')}")
    launches = {}
    for key in arts:
        want = lives[key].forward_batch(inputs[key])
        y = {mode: np.load(specs[mode, key]["jobs"][key]["logits"]) if served[mode, key] else None
             for mode in envs}
        got = torch.from_numpy(y["built"]).to(dev) if y["built"] is not None else want + 1
        rel = float((got - want).abs().max() / want.abs().max())
        n = {mode: served[mode, key].get(key, {}).get("launches", {}) for mode in envs}
        launches[key] = n["carried"]
        want_n = {"deform_attn_fwd": n_d, "x_block_fwd": n_x if key == "pallas" else 0}
        same = y["built"] is not None and y["carried"] is not None and np.array_equal(
            y["built"], y["carried"])
        carried = served["carried", key]
        emit({"phase": "export", "card": card, "part": f"served {key}", "entry": entry[key],
              "fresh_processes_s_beside_the_classifier": fresh_s,
              "fresh_processes": "one an artifact and mode, each started once its artifact "
                                 "was written",
              "beside_all": "the mesh phases' processes (17b-17d)" if settle else None,
              "kernel_libraries_s": {mode: served[mode, key].get(key, {}).get("kernels_s")
                                     for mode in envs},
              "first_call_s": {mode: served[mode, key].get(key, {}).get("first_call_s")
                               for mode in envs},
              "launches_per_forward": n, "want": want_n, "rel_vs_forward_batch": rel,
              "bit_equal_forward_batch": bool(torch.equal(got, want)),
              "bit_equal_built_carried": bool(same), "artifact_bytes": art_bytes[key],
              "carried_nvcc": carried.get("nvcc"), "carried_build_files": carried.get("build_files"),
              "tol_rel": EXPORT_TOL_REL})
        for mode in envs:
            check(n[mode] == want_n, f"export served {key} ({mode}): launches {n[mode]}, want {want_n}")
        check(rel <= EXPORT_TOL_REL, f"export served {key}: rel {rel} vs forward_batch")
        check(same, f"export served {key}: the carried libraries' logits differ from the built ones'")

    # predict_semseg on the raw image: against the live model on the same
    # zero-padded batch (the same computation; a batch of another size runs
    # other cuDNN and cuBLAS algorithms, whose bf16 sums flip near-ties) and
    # the live whole mode (the true-shape forward: padding moves every
    # deformable sample)
    live = lives["portable"]
    h, w = PREDICT_HW
    eh, ew = EXPORT_SHAPES[1]
    img = torch.from_numpy(raw).to(dev).float()
    padded = torch.zeros(TIME_BATCH, eh, ew, 3, device=dev)
    padded[0, :h, :w] = (img - live._mean) / live._std
    with torch.inference_mode():
        same = resize_bilinear(live.forward_batch(padded)[:1], (eh, ew))[0, :h, :w]
        same = same.argmax(-1).to(torch.int32).cpu().numpy()
    whole = live.predict(raw)
    maps = {mode: np.load(roots[mode, "portable"] / "map.npy") if served[mode, "portable"]
            else np.full((h, w), -1, np.int32) for mode in envs}
    got_map = maps["built"]
    share_padded = float((got_map != same).mean())
    share_whole = float((got_map != whole).mean())
    map_entry = served["built", "portable"].get("portable", {}).get("map_entry")
    emit({"phase": "export", "card": card, "part": "predict_semseg", "raw_hw": list(PREDICT_HW),
          "entry": map_entry, "share_differing_live_padded": share_padded,
          "equal_live_padded": share_padded == 0.0,
          "share_differing_live_whole_true_shape": share_whole,
          "tol_share_padded": EVAL_BATCH_SHARE, "equal_carried_built": bool(
              np.array_equal(maps["carried"], got_map)),
          "modules_of_the_fresh_processes": {f"{m} {k}": got.get("modules")
                                             for (m, k), got in served.items()}})
    check(map_entry == f"seg_{eh}x{ew}_b{TIME_BATCH}", f"export predict_semseg: entry {map_entry}")
    check(np.array_equal(maps["carried"], got_map),
          "export predict_semseg: the carried libraries' class map differs from the built one's")
    check(share_padded <= EVAL_BATCH_SHARE,
          f"export predict_semseg: {share_padded} of pixels differ from the live padded forward")

    # the artifact and the live model at batch 16, in turns, once the work
    # beside this phase is done
    if settle is not None:
        mark("10b. export: waiting for the work beside it")
        settle()
    mark("10b. export: its times")
    srv = ServingModel.load(arts["portable"])
    xt = torch.from_numpy(x16).to(dev)
    fns = {"artifact": lambda: srv(entry["portable"], xt), "live": lambda: live.forward_batch(xt)}
    ms = {"artifact": [], "live": []}
    for name in ("artifact", "live", "live", "artifact") * 3:
        ms[name].append(timed(fns[name], 5, warmup=1))
    got, want = fns["artifact"](), fns["live"]()
    rel = float((got - want).abs().max() / want.abs().max())
    emit({"phase": "export", "card": card, "part": "time", "dtype": "bfloat16",
          "batch": TIME_BATCH, "hw": [IMG, IMG], "order": "(artifact live live artifact) x 3",
          "ms_per_batch": ms, "median_ms": {k: statistics.median(v) for k, v in ms.items()},
          "rel_vs_forward_batch": rel, "bit_equal_forward_batch": bool(torch.equal(got, want))})
    check(rel <= EXPORT_TOL_REL, f"export time: batch 16's artifact rel {rel} vs forward_batch")
    for name, fn in fns.items():
        emit(dict(profile_device(torch, fn, card, statistics.median(ms[name]), "forward"),
                  export=name))
    del srv, lives, live, fns
    torch.cuda.empty_cache()
    emit({"phase": "export", "card": card, "part": "wall", "phase_s": time.perf_counter() - t_phase})
    return {"deform_attn_fwd": launches["portable"].get("deform_attn_fwd"),
            "x_block_fwd": launches["pallas"].get("x_block_fwd")}


class LoopProbe:
    """Instruments the trainer from outside while a train CLI call runs:
    K1/K2/K3 launches, the loss (kept on the card, read after the run) and
    wall time per step (around ``make_train_step``'s step), the wait for each
    batch from ``device_prefetch`` (and, with ``keep``, a copy of each batch
    as the step sees it beside its host batch), each
    ``CheckpointManager.save`` and each in-run ``evaluate_dataset`` (each
    timed after a ``synchronize``, so the steps' queued work is not counted
    as theirs). With ``premade`` (batches on the card) the trainer's loader
    is closed unstarted and the step takes those batches in turn. With
    ``sync_at`` the card is synchronized before the batch requests of those
    indices, so a window of iterations starts with no work queued. Everything
    it patches is put back on exit."""

    def __init__(self, torch, keep=False, premade=None, sync_at=()):
        from dat_segmentation_tpu_torch.ops import deform_attn as da
        from dat_segmentation_tpu_torch.ops import x_block as xb
        from dat_segmentation_tpu_torch.train import trainer_seg
        from dat_segmentation_tpu_torch.train.checkpoint import CheckpointManager

        self.torch, self.keep, self.premade, self.sync_at = torch, keep, premade, set(sync_at)
        self.da, self.xb, self.ts, self.cm = da, xb, trainer_seg, CheckpointManager
        self.steps, self.requests, self.saves, self.evals, self.losses = [], [], [], [], []
        self.hosts, self.seen = [], []

    def counts(self):
        return (self.da.deform_attn.launches, self.da.deform_attn_bwd.launches,
                self.xb.x_block_fwd.launches)

    def __enter__(self):
        ts, cm, probe = self.ts, self.cm, self
        self.real = (ts.make_train_step, ts.device_prefetch, ts.evaluate_dataset, cm.save)
        make, prefetch, evaluate, save = self.real

        def make_step(*a, **k):
            step = make(*a, **k)

            def counted(state, batch):
                before = probe.counts()
                out = step(state, batch)
                probe.steps.append(tuple(n - b for n, b in zip(probe.counts(), before)))
                probe.losses.append(out[1]["loss"])
                return out
            return counted

        def timed_prefetch(iterator, *a, **k):
            def host_side():
                for b in iterator:
                    if probe.keep:
                        probe.hosts.append((b["image"], b["label"]))
                    yield b

            def made():
                iterator.close()  # the loader's generator, not started: no threads
                for i in itertools.count():
                    yield dict(probe.premade[i % len(probe.premade)])
            gen = made() if probe.premade else prefetch(host_side(), *a, **k)
            try:
                while True:
                    if len(probe.requests) in probe.sync_at:
                        probe.torch.cuda.synchronize()
                    t = time.perf_counter()
                    try:
                        b = next(gen)
                    except StopIteration:
                        return
                    probe.requests.append((t, time.perf_counter()))
                    if probe.keep:  # on the step's stream, after device_prefetch's wait
                        probe.seen.append((b["image"].clone(), b["label"].clone()))
                    yield b
            finally:
                gen.close()

        def timed_evaluate(*a, **k):
            probe.torch.cuda.synchronize()
            t = time.perf_counter()
            res = evaluate(*a, **k)
            probe.evals.append((t, time.perf_counter() - t, res))
            return res

        def timed_save(mgr, tag, *a, **k):
            probe.torch.cuda.synchronize()
            t = time.perf_counter()
            out = save(mgr, tag, *a, **k)
            probe.saves.append((t, time.perf_counter() - t, tag))
            return out

        ts.make_train_step, ts.device_prefetch, ts.evaluate_dataset = (
            make_step, timed_prefetch, timed_evaluate)
        cm.save = timed_save
        return self

    def __exit__(self, *exc):
        ts, cm = self.ts, self.cm
        ts.make_train_step, ts.device_prefetch, ts.evaluate_dataset, cm.save = self.real
        return False

    def loss_values(self):
        return [float(v) for v in self.losses]

    def iteration_walls(self):
        """Per iteration: (wall less its checkpoint saves and val, its wait
        for the batch), from one batch request to the next."""
        out = []
        for k in range(1, len(self.requests)):
            t0, t1 = self.requests[k - 1][0], self.requests[k][0]
            other = sum(d for t, d, *_ in self.saves + self.evals if t0 <= t < t1)
            out.append((t1 - t0 - other, self.requests[k - 1][1] - t0))
        return out


def train_loop_phase(torch, np, card, n_d, n_x):
    """11. train_loop: the seg trainer end to end on the card through the
    train CLI, with the recipe as it is (see the module docstring). Returns
    the launches of run 1 (K1, K2) and run 3 (K3), counts set to 0 just
    before each run."""
    import shutil
    import tempfile

    from dat_segmentation_tpu_torch import get_config, native
    from dat_segmentation_tpu_torch.data import ade20k as ade
    from dat_segmentation_tpu_torch.data.loader import DataLoader
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.ops import x_block as xb
    from dat_segmentation_tpu_torch.tools import test as test_cli
    from dat_segmentation_tpu_torch.tools import train as train_cli
    from dat_segmentation_tpu_torch.train.checkpoint import CheckpointManager

    root = Path(__file__).resolve().parent / EVAL_DATA
    tmp = Path(tempfile.mkdtemp(prefix="train_loop_"))
    try:
        def layout(name, train_copies):
            data = tmp / name
            for split, copies in (("training", train_copies), ("validation", 1)):
                for kind, suffix in (("images", ".jpg"), ("annotations", ".png")):
                    d = data / kind / split
                    d.mkdir(parents=True)
                    for p in sorted((root / kind / "validation").glob(f"*{suffix}")):
                        for c in range(copies):
                            shutil.copy(p, d / (p.name if copies == 1 else f"{p.stem}_{c}{suffix}"))
            return data

        data = layout("data", LOOP_COPIES)
        steady_data = layout("steady_data", LOOP_STEADY_COPIES)

        def args(run, iters, *flags, sets=(), root=data):
            return [TRAIN_PRESET, "--data-root", str(root), "--work-dir", str(tmp / run),
                    "--max-iters", str(iters), *flags, "--set", *LOOP_SETS, *sets]

        def reset():
            da.deform_attn.launches = da.deform_attn_bwd.launches = xb.x_block_fwd.launches = 0

        # -- run 1: the recipe, 6 iterations --------------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        with LoopProbe(torch, keep=True) as p1:
            state, hist = train_cli.main(args("run1", LOOP_ITERS))
        torch.cuda.synchronize()
        run1_s = time.perf_counter() - t0
        launches = {"deform_attn_fwd": da.deform_attn.launches,
                    "deform_attn_bwd": da.deform_attn_bwd.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        run_dir = tmp / "run1" / TRAIN_PRESET
        names = sorted(p.name for p in run_dir.glob("ckpt_*"))
        want_names = sorted(f"ckpt_{t}{s}" for t in (3, 6, "best") for s in ("", ".meta.json"))
        metas = {t: json.loads((run_dir / f"ckpt_{t}.meta.json").read_text())
                 for t in (3, 6, "best") if (run_dir / f"ckpt_{t}.meta.json").exists()}
        stream_equal = [bool(torch.equal(img.cpu(), torch.from_numpy(hi))
                             and torch.equal(lab.cpu(), torch.from_numpy(hl)))
                        for (img, lab), (hi, hl) in zip(p1.seen, p1.hosts)]
        del p1.seen, p1.hosts
        walls = p1.iteration_walls()[1:LOOP_ITERS]  # iterations 2-6
        loop_s = sum(w for w, _ in walls)
        (_, eval_s, res), = p1.evals or [(0, None, {"num_images": 0, "mIoU": float("nan")})]
        del state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli = test_cli.main([TRAIN_PRESET, str(run_dir / "ckpt_best"), "--data-root", str(data),
                             "--batch-size", "1"])
        cli_s = time.perf_counter() - t0
        cli_equal = cli["inter"] == res.get("inter") and cli["union"] == res.get("union")
        emit({"phase": "train_loop", "card": card, "run": "recipe", "preset": TRAIN_PRESET,
              "dtype": "bfloat16", "batch": 16, "iterations": LOOP_ITERS, "sets": LOOP_SETS,
              "train_items": len(list((data / "images" / "training").iterdir())),
              "losses": hist["loss"], "launches": launches,
              "launches_per_step": [dict(zip(("deform_attn_fwd", "deform_attn_bwd", "x_block_fwd"),
                                             s)) for s in p1.steps],
              "ms_per_step_2_6": [w * 1e3 for w, _ in walls],
              "ms_per_step": loop_s / len(walls) * 1e3 if walls else None,
              "img_per_s": 16 * len(walls) / loop_s if walls else None,
              "data_wait_share_per_step": [w / t for t, w in walls],
              "data_wait_share": sum(w for _, w in walls) / loop_s if walls else None,
              "batches_equal_host": stream_equal,
              "ckpt_save_s": {str(tag): d for _, d, tag in p1.saves}, "ckpt_names": names,
              "meta_classes": {str(t): len(m.get("CLASSES", [])) for t, m in metas.items()},
              "val_miou": res["mIoU"], "val_images": res["num_images"], "eval_s": eval_s,
              "test_cli_s": cli_s, "test_cli_counts_equal": cli_equal,
              "peak_mem_gib": peak, "wall_s": run1_s})
        check(len(hist["loss"]) == LOOP_ITERS and all(np.isfinite(hist["loss"])),
              f"train_loop: losses {hist['loss']}")
        check(p1.steps == [(n_d, n_d, 0)] * LOOP_ITERS,
              f"train_loop: launches per step {p1.steps}, want ({n_d}, {n_d}, 0) each")
        check(len(stream_equal) >= LOOP_ITERS and all(stream_equal),
              f"train_loop: batches on the card equal to the host's: {stream_equal}")
        check(names == want_names, f"train_loop: checkpoints {names}, want {want_names}")
        check(all(len(m.get("CLASSES", [])) == 150 for m in metas.values()) and len(metas) == 3,
              "train_loop: checkpoint meta without the 150 classes")
        check(res["num_images"] == 6 and 0.0 <= res["mIoU"] <= 1.0,
              f"train_loop: in-run val {res['num_images']} images, mIoU {res['mIoU']}")
        check(cli_equal, "train_loop: the test CLI on ckpt_best differs from the in-run val")

        # -- the loader alone: img/s at batch 16 on the 48-item split (its
        # pipeline two batches ahead across batches), and per item its stages --
        train_ds = ade.ADE20KDataset(data, "train")
        loader = DataLoader(ade.ADE20KDataset(steady_data, "train"), 16, shuffle=True,
                            drop_last=True, infinite=True)
        it = iter(loader)
        premade = [{k: torch.from_numpy(v).cuda() if isinstance(v, np.ndarray) else v
                    for k, v in next(it).items()}]  # threads started, the library loaded
        t0 = time.perf_counter()
        for _ in range(6):
            b = next(it)
            if len(premade) < 3:
                premade.append(b)
        loader_ips = 6 * 16 / (time.perf_counter() - t0)
        it.close()
        premade[1:] = [{k: torch.from_numpy(v).cuda() if isinstance(v, np.ndarray) else v
                        for k, v in b.items()} for b in premade[1:]]
        stage_s = {k: 0.0 for k in ("decode", "resize", "crop", "photometric", "normalize")}
        patched = [(train_ds, "load_raw", "decode"), (ade, "resize", "resize"),
                   (ade, "random_crop", "crop"), (native, "photometric_distortion_u8", "photometric"),
                   (native, "normalize_pad_f32", "normalize")]
        real = [getattr(o, n) for o, n, _ in patched]

        def stage(fn, key):
            def timed_fn(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                stage_s[key] += time.perf_counter() - t
                return out
            return timed_fn

        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as in a loader thread
        try:
            for (o, n, key), fn in zip(patched, real):
                setattr(o, n, stage(fn, key))
            t0 = time.perf_counter()
            for i in range(len(train_ds)):
                train_ds[i]
            item_s = (time.perf_counter() - t0) / len(train_ds)
        finally:
            for (o, n, _), fn in zip(patched, real):
                setattr(o, n, fn)
            torch.set_num_threads(threads)
        emit({"phase": "train_loop", "card": card, "run": "loader", "batch": 16,
              "threads": loader.num_threads, "train_items": len(loader.dataset),
              "batches_an_epoch": len(loader), "img_per_s": loader_ips,
              "item_ms": item_s * 1e3,
              "item_stage_ms": {k: v / len(train_ds) * 1e3 for k, v in stage_s.items()},
              "recipe_step_img_per_s": 16 * len(walls) / loop_s if walls else None})

        # -- the loop in steady state: iterations 8-14, no checkpoints -------------
        log_every = f"log_interval={get_config(TRAIN_PRESET).log_interval}"
        steady_sets = ("checkpoint_interval=1000000", "eval_interval=1000000")
        for run, batches, log in (("steady", None, log_every), ("steady_premade", premade, log_every),
                                  ("steady_premade_log1", premade, "log_interval=1")):
            with LoopProbe(torch, premade=batches, sync_at=(LOOP_STEADY_FROM - 1,)) as ps:
                state, _ = train_cli.main(args(run, LOOP_STEADY_ITERS, root=steady_data,
                                               sets=steady_sets + (log,)))
            del state
            torch.cuda.empty_cache()
            losses = ps.loss_values()
            steady = ps.iteration_walls()[LOOP_STEADY_FROM - 1:LOOP_STEADY_ITERS]
            steady_s = sum(w for w, _ in steady)
            wait_s = sum(w for _, w in steady)
            emit({"phase": "train_loop", "card": card, "run": run, "batch": 16,
                  "loader": "threads" if batches is None else "premade batches on the card",
                  "train_items": LOOP_STEADY_COPIES * 6, "sets": steady_sets + (log,),
                  "iterations": f"{LOOP_STEADY_FROM}-{LOOP_STEADY_ITERS}",
                  "ms_per_step": [w * 1e3 for w, _ in steady],
                  "ms_per_step_mean": steady_s / len(steady) * 1e3,
                  "img_per_s": 16 * len(steady) / steady_s,
                  "data_wait_share_per_step": [w / t for t, w in steady],
                  "data_wait_share": wait_s / steady_s,
                  "ms_per_step_less_wait": (steady_s - wait_s) / len(steady) * 1e3,
                  "loader_alone_img_per_s": loader_ips, "losses": losses})
            check(len(losses) == LOOP_STEADY_ITERS and all(np.isfinite(losses))
                  and ps.steps == [(n_d, n_d, 0)] * LOOP_STEADY_ITERS,
                  f"train_loop {run}: losses {losses}, launches {ps.steps}")

        # -- run 2: 3 iterations, the checkpoint restored, then --resume to 6 -------
        with LoopProbe(torch) as p2:
            state, hist2 = train_cli.main(args("run2", LOOP_RESUME_AT))
        mgr = CheckpointManager(tmp / "run2" / TRAIN_PRESET)
        t0 = time.perf_counter()
        saved = mgr.restore(LOOP_RESUME_AT, map_location="cpu")
        load_s = time.perf_counter() - t0
        same = {"step": saved["step"] == state.step == LOOP_RESUME_AT,
                "model": all(torch.equal(saved["model"][k], v.cpu())
                             for k, v in state.model.state_dict().items()),
                "generator": torch.equal(saved["generator"], state.generator.get_state())}
        opt = state.optimizer.state_dict()
        same["optimizer"] = saved["optimizer"]["param_groups"] == opt["param_groups"] and all(
            torch.equal(torch.as_tensor(saved["optimizer"]["state"][i][k]).cpu(),
                        torch.as_tensor(v).cpu()) for i, st in opt["state"].items()
            for k, v in st.items())
        del state, saved, opt
        torch.cuda.empty_cache()
        with LoopProbe(torch) as p3:
            state, hist3 = train_cli.main(args("run2", LOOP_ITERS, "--resume"))
        log = (tmp / "run2" / TRAIN_PRESET / "train.log").read_text()
        resumed = f"resumed from iter {LOOP_RESUME_AT}" in log
        end_step = state.step
        del state
        torch.cuda.empty_cache()
        emit({"phase": "train_loop", "card": card, "run": "resume", "first_losses": hist2["loss"],
              "restored_equal": same, "ckpt_load_s": load_s,
              "ckpt_save_s": {str(tag): d for _, d, tag in p2.saves + p3.saves},
              "resumed_logged": resumed, "resumed_losses": hist3["loss"], "end_step": end_step,
              "note": "the loader restarts at epoch 0 on resume, as in the JAX trainer: "
                      "the resumed losses are not those of run 1"})
        check(all(same.values()), f"train_loop resume: checkpoint restore differs: {same}")
        check(resumed and end_step == LOOP_ITERS
              and len(hist3["loss"]) == LOOP_ITERS - LOOP_RESUME_AT
              and all(np.isfinite(hist3["loss"])),
              f"train_loop resume: logged {resumed}, end step {end_step}, losses {hist3['loss']}")

        # -- run 3: kernel_impl='pallas', 2 iterations ----------------------------
        reset()
        with LoopProbe(torch) as p4:
            state, hist4 = train_cli.main(args("run3", LOOP_PALLAS_ITERS,
                                               sets=("model.backbone.kernel_impl=pallas",)))
        k3_launches = xb.x_block_fwd.launches
        del state
        torch.cuda.empty_cache()
        emit({"phase": "train_loop", "card": card, "run": "pallas", "kernel_impl": "pallas",
              "losses": hist4["loss"], "launches_per_step": [
                  dict(zip(("deform_attn_fwd", "deform_attn_bwd", "x_block_fwd"), s))
                  for s in p4.steps], "x_block_fwd_launches": k3_launches})
        check(p4.steps == [(n_d, n_d, n_x)] * LOOP_PALLAS_ITERS and all(np.isfinite(hist4["loss"])),
              f"train_loop pallas: launches {p4.steps} (want ({n_d}, {n_d}, {n_x}) each), "
              f"losses {hist4['loss']}")
        launches["x_block_fwd"] = k3_launches
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cls_phases(torch, np, card, dev, h):
    """12-16. The classifier slice on the card (see the module docstring).
    ``h`` holds main's helpers (``timed``, ``k1_inputs``, ``k1_stage_time``,
    ``k2_stage_time``, ``add_stage``). Returns each kernel's launches by path
    (the counts set to 0 just before each path runs)."""
    from dataclasses import replace

    from dat_segmentation_tpu_torch import build_model, create_train_state, get_config
    from dat_segmentation_tpu_torch import make_train_step
    from dat_segmentation_tpu_torch.data.mixup import MixupDraws
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.ops import x_block as xb
    from dat_segmentation_tpu_torch.tools.k3_time import stock_chain, xb_inputs
    from dat_segmentation_tpu_torch.train.train_step import make_cls_metric_step

    timed = h["timed"]
    tcfg = get_config(CLS_PRESET)
    mc = tcfg.model
    stages = stage_geometry(mc.backbone, CLS_IMG)
    n_d = sum(s["launches_per_forward"] for s in stages)
    n_x = k3_gate_count(mc.backbone, CLS_IMG, CLS_IMG)
    scale = 32 ** -0.5
    t_phase = time.perf_counter()

    def reset():
        da.deform_attn.launches = da.deform_attn_bwd.launches = xb.x_block_fwd.launches = 0

    def counts():
        return {"deform_attn_fwd": da.deform_attn.launches,
                "deform_attn_bwd": da.deform_attn_bwd.launches,
                "x_block_fwd": xb.x_block_fwd.launches}

    def with_impl(model_cfg, impl):
        return replace(model_cfg, backbone=replace(model_cfg.backbone, kernel_impl=impl))

    class Fixed:  # stands in for the train state's MixupSampler
        def draw(self, h_, w_):
            return MixupDraws(**CLS_DRAWS)

    # ---- 12. cls_kernel_check: K1 and K2 at the classifier's four stages ----
    mark("12. cls_kernel_check")
    t0 = time.perf_counter()
    for s in stages:
        for dtype, tol, btol in ((torch.float32, TOL_F32, TOL_BWD_F32),
                                 (torch.bfloat16, TOL_BF16, TOL_BWD_BF16)):
            q, k, v, pos, table = h["k1_inputs"](B=CLS_BATCH, dtype=dtype, **s)
            kw = dict(n_groups=s["g"], scale=scale)
            with torch.inference_mode():
                got = da.deform_attn(q, k, v, pos, table, **kw)
                ref, ref_lse = da.deform_attn_reference(q, k, v, pos, table, return_lse=True, **kw)
                got_t, lse = da._fwd_kernel(q, k, v, pos, table, s["g"], scale, 0, 0,
                                            with_lse=True)
            dout = torch.tensor(np.random.RandomState(SEED + 9).randn(*q.shape),
                                dtype=torch.float32, device=dev).to(dtype)
            bgot = da.deform_attn_bwd(q, k, v, pos, table, dout, **kw)
            bref = da.deform_attn_bwd_reference(q, k, v, pos, table, dout, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse.float()).abs().max().item()
            same = torch.equal(got, got_t)
            rel = {n: (a.float() - b.float()).abs().max().item()
                   / max(b.float().abs().max().item(), 1e-12)
                   for n, a, b in zip(GRADS, bgot, bref)}
            emit({"phase": "cls_kernel_check", "card": card, "stage": s["stage"],
                  "dtype": str(dtype).split(".")[1], "q": list(q.shape), "k": list(k.shape),
                  "table": list(table.shape), "batch_groups": q.shape[0],
                  "deform_attn_fwd": {"max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
                                      "tol_lse": TOL_LSE,
                                      "serving_output_equals_training_launch": same},
                  "deform_attn_bwd": {"max_rel_err": rel, "tol_rel": btol}})
            what = f"cls_kernel_check stage {s['stage']} {dtype}"
            check(err <= tol and got.shape == ref.shape, f"{what}: K1 {err} > {tol}")
            check(lse_err <= TOL_LSE, f"{what}: K1 log-sum-exp {lse_err} > {TOL_LSE}")
            check(same, f"{what}: the log-sum-exp launch moved K1's output")
            check(max(rel.values()) <= btol and all(a.shape == b.shape for a, b in zip(bgot, bref)),
                  f"{what}: K2 {rel} > {btol}")
            del q, k, v, pos, table, got, ref, got_t, lse, ref_lse, dout, bgot, bref
    torch.cuda.empty_cache()
    emit({"phase": "cls_kernel_check", "card": card, "seconds": time.perf_counter() - t0})

    # ---- 13. cls_model: float32, TF32 off, card against CPU -----------------
    mark("13. cls_model")
    quiet = replace(mc, backbone=replace(mc.backbone, drop_path_rate=0.0))
    rng = np.random.RandomState(SEED + 11)
    image = torch.tensor(rng.randn(CLS_MODEL_BATCH, CLS_IMG, CLS_IMG, 3), dtype=torch.float32)
    batch = {"image": image, "label": torch.tensor(rng.randint(0, mc.num_classes,
                                                                CLS_MODEL_BATCH))}
    torch.manual_seed(SEED)
    weights = build_model(quiet, device="cpu").state_dict()
    logits_by_impl = {}
    for impl in ("auto", "pallas"):
        qcfg = with_impl(quiet, impl)
        gmodel = build_model(qcfg, device=dev)
        gmodel.load_state_dict(weights)
        cmodel = build_model(qcfg, device="cpu")
        cmodel.load_state_dict(weights)
        reset()
        with torch.inference_mode():
            glog = gmodel(image.to(dev)).float()
            torch.cuda.synchronize()
            fwd_launches = counts()
            clog = cmodel(image)
        logits_by_impl[impl] = glog.cpu()
        dlogit = (glog.cpu() - clog).abs().max().item()
        runs = {}
        for where, m in (("card", gmodel), ("cpu", cmodel)):
            st = create_train_state(m, replace(tcfg, model=qcfg,
                                               schedule=replace(tcfg.schedule, warmup_iters=0)))
            st.mixup = Fixed()
            stp = make_train_step(m, task="cls", num_classes=mc.num_classes,
                                  compute_dtype=torch.float32, mixup=True)
            reset()
            t1 = time.perf_counter()
            _, met = stp(st, batch)
            if where == "card":
                torch.cuda.synchronize()
            runs[where] = dict(metrics={k: v.cpu() for k, v in met.items()}, launches=counts(),
                               seconds=time.perf_counter() - t1)
        gm, cm = runs["card"]["metrics"], runs["cpu"]["metrics"]
        loss_rel = abs(gm["loss"].item() - cm["loss"].item()) / abs(cm["loss"].item())
        grad_rel, worst, off, _, gsq = grad_compare(gmodel, cmodel)
        want_fwd = {"deform_attn_fwd": n_d, "deform_attn_bwd": 0,
                    "x_block_fwd": n_x if impl == "pallas" else 0}
        want_step = dict(want_fwd, deform_attn_bwd=n_d)
        emit({"phase": "cls_model", "card": card, "preset": CLS_PRESET, "kernel_impl": impl,
              "dtype": "float32", "tf32": False, "input": list(image.shape),
              "logits": list(glog.shape), "max_abs_dlogit": dlogit, "tol": TOL_MODEL,
              "logit_absmax": clog.abs().max().item(),
              "argmax_agreement": (glog.cpu().argmax(-1) == clog.argmax(-1)).float().mean().item(),
              "forward_launches": fwd_launches, "step_launches": runs["card"]["launches"],
              "mixup_draws": CLS_DRAWS, "drop_path": 0.0,
              "loss_card": gm["loss"].item(), "loss_cpu": cm["loss"].item(),
              "loss_rel_err": loss_rel, "acc1_card": gm["acc1"].item(),
              "acc1_cpu": cm["acc1"].item(), "grad_rel_err": grad_rel, "worst_param": worst[2],
              "worst_param_rel_err": worst[0] / max(worst[1], 1e-30),
              "grad_norm_total": gsq ** 0.5, "card_step_s": runs["card"]["seconds"],
              "cpu_step_s": runs["cpu"]["seconds"],
              "tol_step": {"loss": TOL_TRAIN_LOSS, "grad": TOL_GRAD, "grad_param": TOL_GRAD_PARAM}})
        what = f"cls_model {impl}"
        check(dlogit <= TOL_MODEL and bool(torch.isfinite(glog).all()),
              f"{what}: max |dlogit| {dlogit} > {TOL_MODEL}")
        check(fwd_launches == want_fwd, f"{what}: forward launches {fwd_launches}, want {want_fwd}")
        check(runs["card"]["launches"] == want_step,
              f"{what}: step launches {runs['card']['launches']}, want {want_step}")
        check(loss_rel <= TOL_TRAIN_LOSS, f"{what}: loss rel err {loss_rel} > {TOL_TRAIN_LOSS}")
        check(grad_rel <= TOL_GRAD, f"{what}: grad rel err {grad_rel} > {TOL_GRAD}")
        check(not off, f"{what}: gradients beyond {TOL_GRAD_PARAM}: {off}")
        check(gm["acc1"].item() == cm["acc1"].item(), f"{what}: acc1 {gm['acc1']} vs {cm['acc1']}")
        del gmodel, cmodel, runs
    d_fused = (logits_by_impl["pallas"] - logits_by_impl["auto"]).abs().max().item()
    check(d_fused <= TOL_MODEL, f"cls_model: pallas vs auto on the card {d_fused} > {TOL_MODEL}")
    torch.cuda.empty_cache()

    # ---- 14. cls_serve: the bf16 forward and metric step at batch 128 -------
    mark("14. cls_serve")
    torch.manual_seed(SEED)
    models = {impl: build_model(with_impl(mc, impl), device=dev) for impl in ("auto", "pallas")}
    models["pallas"].load_state_dict(models["auto"].state_dict())
    fns = {impl: make_cls_metric_step(m, compute_dtype=torch.bfloat16) for impl, m in models.items()}
    rng = np.random.RandomState(SEED + 12)
    x = torch.tensor(rng.randn(CLS_BATCH, CLS_IMG, CLS_IMG, 3), dtype=torch.float32, device=dev)
    label = torch.tensor(rng.randint(0, mc.num_classes, CLS_BATCH), device=dev)
    pad = CLS_BATCH // 16  # a padded tail of 8 rows at batch 128
    valid = torch.arange(CLS_BATCH, device=dev) < CLS_BATCH - pad
    serve = {}
    for impl, fn in fns.items():
        torch.cuda.synchronize()
        reset()
        got = fn(x, label, valid)
        torch.cuda.synchronize()
        serve[impl] = counts()
        hits = got.tolist()
        want = {"deform_attn_fwd": n_d, "deform_attn_bwd": 0,
                "x_block_fwd": n_x if impl == "pallas" else 0}
        emit({"phase": "cls_serve", "card": card, "kernel_impl": impl, "dtype": "bfloat16",
              "batch": CLS_BATCH, "valid": int(valid.sum()), "hits1_hits5_total": hits,
              "launches": serve[impl]})
        check(serve[impl] == want, f"cls_serve {impl}: launches {serve[impl]}, want {want}")
        check(got.dtype == torch.int32 and hits[2] == CLS_BATCH - pad
              and 0 <= hits[0] <= hits[1] <= hits[2], f"cls_serve {impl}: counts {hits}")
    with torch.inference_mode():  # the forward alone, bf16, as the metric step runs it
        bf16_logits = torch.func.functional_call(
            models["auto"], {n: p.to(torch.bfloat16) for n, p in models["auto"].named_parameters()},
            (x.to(torch.bfloat16),))
    check(bool(torch.isfinite(bf16_logits).all())
          and bf16_logits.shape == (CLS_BATCH, mc.num_classes),
          "cls_serve: bf16 logits not finite or of the wrong shape")
    ms = {"auto": [], "pallas": []}
    for impl in ("auto", "pallas", "pallas", "auto") * 3:
        ms[impl].append(timed(lambda: fns[impl](x, label, valid), 10))
    peak = {}
    for impl, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(x, label, valid)
        torch.cuda.synchronize()
        peak[impl] = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {k: statistics.median(v) for k, v in ms.items()}
    emit({"phase": "cls_serve", "card": card, "dtype": "bfloat16", "batch": CLS_BATCH,
          "compare": "kernel_impl auto vs pallas, in turns", "order": "(auto pallas pallas auto) x 3",
          "ms": ms, "median_ms": med,
          "img_per_s": {k: [CLS_BATCH / v * 1e3 for v in vs] for k, vs in ms.items()},
          "median_img_per_s": {k: CLS_BATCH / v * 1e3 for k, v in med.items()},
          "peak_mem_gib": peak})
    for impl in ("auto", "pallas"):
        prof = profile_device(torch, lambda: fns[impl](x, label, valid), card, med[impl],
                              "forward")
        emit(dict(prof, preset=CLS_PRESET, kernel_impl=impl, batch=CLS_BATCH))
    del models, fns, x, bf16_logits
    torch.cuda.empty_cache()

    # ---- 15. cls_train: the preset as it is, bf16, batch 128 ----------------
    mark("15. cls_train")
    ncfg = replace(tcfg, schedule=replace(tcfg.schedule, warmup_iters=0))
    torch.manual_seed(SEED)
    steps = {}
    for impl in ("auto", "pallas"):
        m = build_model(with_impl(mc, impl), device=dev)
        if impl == "pallas":
            m.load_state_dict(steps["auto"][2].state_dict())
        st = create_train_state(m, replace(ncfg, model=with_impl(mc, impl)))
        steps[impl] = (make_train_step(m, task="cls", num_classes=mc.num_classes,
                                       compute_dtype=torch.bfloat16, mixup=True), st, m)
    rng = np.random.RandomState(SEED + 13)
    b128 = {"image": torch.tensor(rng.randn(CLS_BATCH, CLS_IMG, CLS_IMG, 3), dtype=torch.float32,
                                  device=dev),
            "label": torch.tensor(rng.randint(0, mc.num_classes, CLS_BATCH), device=dev)}
    train = {}
    for impl, (fn, st, _) in steps.items():
        torch.cuda.synchronize()
        reset()
        mets = [fn(st, b128)[1] for _ in range(CLS_TRAIN_STEPS)]
        torch.cuda.synchronize()
        train[impl] = counts()
        losses = [mm["loss"].item() for mm in mets]
        gnorms = [mm["grad_norm"].item() for mm in mets]
        want = {"deform_attn_fwd": n_d * CLS_TRAIN_STEPS, "deform_attn_bwd": n_d * CLS_TRAIN_STEPS,
                "x_block_fwd": (n_x if impl == "pallas" else 0) * CLS_TRAIN_STEPS}
        emit({"phase": "cls_train", "card": card, "preset": CLS_PRESET, "kernel_impl": impl,
              "dtype": "bfloat16", "batch": CLS_BATCH, "steps": CLS_TRAIN_STEPS,
              "drop_path_rate": mc.backbone.drop_path_rate, "mixup": True,
              "grad_clip": tcfg.optimizer.grad_clip, "warmup_iters": 0,
              "losses": losses, "grad_norms": gnorms,
              "acc1": [mm["acc1"].item() for mm in mets],
              "update_ratios": [mm["update_ratio"].item() for mm in mets],
              "launches": train[impl],
              "launches_per_step": {k: v / CLS_TRAIN_STEPS for k, v in train[impl].items()}})
        check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
              f"cls_train {impl}: non-finite loss or grad norm {losses} {gnorms}")
        check(train[impl] == want, f"cls_train {impl}: launches {train[impl]}, want {want}")
    sms = {"auto": [], "pallas": []}
    for impl in ("auto", "pallas", "pallas", "auto"):
        fn, st, _ = steps[impl]
        sms[impl].append(timed(lambda: fn(st, b128), CLS_TIME_STEPS, warmup=1))
    speak = {}
    for impl, (fn, st, _) in steps.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(st, b128)
        torch.cuda.synchronize()
        speak[impl] = torch.cuda.max_memory_allocated() / 2 ** 30
    smed = {k: statistics.median(v) for k, v in sms.items()}
    fn, st, _ = steps["auto"]
    prof = profile_device(torch, lambda: fn(st, b128), card, smed["auto"], "step", iters=2)
    k1tot, k2tot = {}, {}
    for s in stages:
        row = h["k1_stage_time"](s, CLS_BATCH)
        h["add_stage"](k1tot, row)
        emit({"phase": "cls_kernel_time", "card": card, **row})
        row = h["k2_stage_time"](s, CLS_BATCH)
        h["add_stage"](k2tot, row)
        emit({"phase": "cls_kernel_time", "card": card, **row})
    # K3 at the classifier's shapes: its gate fuses stage 0 only (56², C 64),
    # an 'X' block and a 'D' block's MLP half, n_x launches a forward
    xrows = x_block_bound(mc.backbone, stages[:1], card, batch=CLS_BATCH)["rows"]
    check(sum(r["calls_per_forward"] for r in xrows) == n_x,
          f"cls_kernel_time: K3 rows {xrows}, want {n_x} launches")
    for row in xrows:
        mode = "lpu" if row["mode"] == "X" else "mlp"
        B, H, W, C = row["x"]
        x, prm = xb_inputs(dev, torch.bfloat16, B=B, H=H, W=W, C=C, k=row["k"], mode=mode)
        args = [prm[n] for n in XB_PARAMS]
        lpu = mode == "lpu"
        with torch.inference_mode():
            ms = timed(lambda: xb.x_block_fwd(x, *args, with_lpu=lpu), 20)
            plain_ms = timed(lambda: xb.x_block_reference(x, *args, with_lpu=lpu), 5, 1)
            chain_ms = timed(lambda: stock_chain(x, prm, mode), 10)
        emit({"phase": "cls_kernel_time", "card": card, "kernel": "x_block_fwd",
              "stage": row["stage"], "mode": row["mode"], "dtype": "bfloat16", "batch": B,
              "x": row["x"], "k": row["k"], "launches_per_forward": row["calls_per_forward"],
              "ms": ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
              "yardstick": "the unfused stock-op chain, not one call",
              "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
              "roofline_share": row["bound_ms"] / ms, "chain_over_kernel": chain_ms / ms})
        del x, prm, args
    k12 = sum(prof.get("kernels_ms", {}).get(k, 0.0) for k in ("deform_attn_fwd", "deform_attn_bwd"))
    emit({"phase": "cls_train", "card": card, "dtype": "bfloat16", "batch": CLS_BATCH,
          "compare": "kernel_impl auto vs pallas, in turns", "order": "auto pallas pallas auto",
          "ms_per_step": sms, "median_ms_per_step": smed,
          "img_per_s": {k: [CLS_BATCH / v * 1e3 for v in vs] for k, vs in sms.items()},
          "median_img_per_s": {k: CLS_BATCH / v * 1e3 for k, v in smed.items()},
          "peak_mem_gib": speak,
          "deform_attn_fwd_ms_per_step": k1tot, "deform_attn_bwd_ms_per_step": k2tot,
          "k1_k2_share_profiled": (k12 / prof["device_ms_per_step"]
                                   if "device_ms_per_step" in prof else None)})
    emit(dict(prof, preset=CLS_PRESET, batch=CLS_BATCH))
    del steps, b128, fn, st, prof
    torch.cuda.empty_cache()

    # ---- 16. cls_loop: the classifier trainer through the train CLI ---------
    mark("16. cls_loop")
    loop = cls_loop_phase(torch, np, card, n_d, reset, counts)
    emit({"phase": "cls_phases", "card": card, "seconds": time.perf_counter() - t_phase})
    out = {name: {} for name in ("deform_attn_fwd", "deform_attn_bwd", "x_block_fwd")}
    out["deform_attn_fwd"].update(cls_serve=serve["auto"]["deform_attn_fwd"],
                                  cls_train=train["auto"]["deform_attn_fwd"],
                                  cls_loop=loop["deform_attn_fwd"])
    out["deform_attn_bwd"].update(cls_train=train["auto"]["deform_attn_bwd"],
                                  cls_loop=loop["deform_attn_bwd"])
    out["x_block_fwd"].update(cls_serve=serve["pallas"]["x_block_fwd"],
                              cls_train=train["pallas"]["x_block_fwd"])
    return out


def cls_loop_phase(torch, np, card, n_d, reset, counts):
    """16. cls_loop: ``tools/train.py:main`` on cls_tiny_imagenet over the
    fixture ``tests/data/imagenet_tiny`` (12 train, 6 val images), batch 4,
    bf16, the preset's mixup, drop path and clip, warm-up 0. Run 1, two
    epochs of three steps: finite losses, 14 K1 and 14 K2 launches a step,
    ``ckpt_2``, ``ckpt_best`` and ``backbone_best``, and the in-run val's
    top-1/5 counts equal to a recount with ``make_cls_metric_step`` on
    ``best``. Run 2: a SIGTERM notice at step 3 writes ``ckpt_1``; the
    resume restores it bit for bit (model, AdamW, step, the dropout
    generator, the mixup sampler) and trains to step 6. Then the loader
    alone on 96 synthetic JPEGs at ImageNet's size (``imagenet_like_jpegs``),
    and per item the ms of each transform step.
    Returns run 1's K1 and K2 launches."""
    import random
    import shutil
    import tempfile

    from dat_segmentation_tpu_torch import build_model, get_config
    from dat_segmentation_tpu_torch.data import imagenet
    from dat_segmentation_tpu_torch.data.image_io import imread_rgb
    from dat_segmentation_tpu_torch.data.loader import DataLoader
    from dat_segmentation_tpu_torch.tools import train as train_cli
    from dat_segmentation_tpu_torch.train import trainer_cls
    from dat_segmentation_tpu_torch.train.checkpoint import load_pretrained
    from dat_segmentation_tpu_torch.train.train_step import make_cls_metric_step

    root = Path(__file__).resolve().parent / CLS_DATA
    tmp = Path(tempfile.mkdtemp(prefix="cls_loop_"))
    real = (trainer_cls.make_train_step, trainer_cls.evaluate_topk, trainer_cls._restore_state,
            trainer_cls.PreemptionGuard.should_checkpoint)
    seen = {"steps": [], "losses": [], "val": [], "restored": []}

    def make_step(*a, **k):
        step = real[0](*a, **k)

        def counted(state, batch):
            before = counts()
            out = step(state, batch)
            seen["steps"].append({n: counts()[n] - before[n] for n in before})
            seen["losses"].append(out[1]["loss"])
            return out
        return counted

    def evaluate(*a, **k):
        res = real[1](*a, **k)
        seen["val"].append(res.tolist())
        return res

    def restore(st, saved):
        out = real[2](st, saved)
        model_eq = all(torch.equal(v.cpu(), saved["model"][k].cpu())
                       for k, v in st.model.state_dict().items())
        opt, sopt = st.optimizer.state_dict(), saved["optimizer"]
        opt_eq = all(torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(sopt["state"][i][k]).cpu())
                     for i, s_ in opt["state"].items() for k, v in s_.items())
        seen["restored"].append({"model": model_eq, "adamw": opt_eq,
                                 "step": st.step == saved["step"],
                                 "generator": torch.equal(st.generator.get_state(),
                                                          saved["generator"]),
                                 "mixup": st.mixup.get_state() == saved["mixup"]})
        return out

    def args(run, *flags):
        return [CLS_PRESET, "--data-root", str(root), "--work-dir", str(tmp / run),
                "--epochs", str(CLS_LOOP_EPOCHS), *flags, "--set", *CLS_LOOP_SETS]

    try:
        trainer_cls.make_train_step, trainer_cls.evaluate_topk = make_step, evaluate
        trainer_cls._restore_state = restore
        # -- run 1: two epochs ---------------------------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        state, hist = train_cli.main(args("run1"))
        torch.cuda.synchronize()
        run1_s = time.perf_counter() - t0
        launches = counts()
        run_dir = tmp / "run1" / CLS_PRESET
        names = sorted(p.name for p in run_dir.iterdir() if p.name.startswith(("ckpt_", "backbone")))
        losses = [float(v) for v in seen["losses"]]
        best_epoch = int(np.argmax(hist["val_acc1"]))  # the first epoch at the best top-1
        bmodel = build_model(get_config(CLS_PRESET).model, device=torch.device("cuda"))
        bmodel.load_state_dict(load_pretrained(str(run_dir / "ckpt_best"),
                                               get_config(CLS_PRESET).model, kind="classifier"))
        val_ds = imagenet.ImageNetDataset(str(root), "val", size=CLS_IMG)
        again = real[1](make_cls_metric_step(bmodel, compute_dtype=torch.bfloat16), val_ds,
                        CLS_LOOP_BATCH).tolist()
        del bmodel, state
        steps_n = len(seen["steps"])
        emit({"phase": "cls_loop", "card": card, "run": "two epochs", "preset": CLS_PRESET,
              "dtype": "bfloat16", "batch": CLS_LOOP_BATCH, "epochs": CLS_LOOP_EPOCHS,
              "sets": CLS_LOOP_SETS, "losses": losses, "launches": launches,
              "launches_per_step": seen["steps"], "val_counts": seen["val"],
              "val_acc1": hist["val_acc1"], "val_acc5": hist["val_acc5"],
              "recount_on_best": again, "ckpt_names": names, "wall_s": run1_s,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        want = {"deform_attn_fwd": n_d, "deform_attn_bwd": n_d, "x_block_fwd": 0}
        check(steps_n == 6 and all(np.isfinite(losses)), f"cls_loop: steps {steps_n}, {losses}")
        check(all(st_ == want for st_ in seen["steps"]),
              f"cls_loop: launches a step {seen['steps']}, want {want}")
        check(names == ["backbone_best", "ckpt_2", "ckpt_2.meta.json", "ckpt_best",
                        "ckpt_best.meta.json"], f"cls_loop: checkpoints {names}")
        check(len(seen["val"]) == 2 and all(v[2] == 6 for v in seen["val"]),
              f"cls_loop: val counts {seen['val']}")
        check(again == seen["val"][best_epoch],
              f"cls_loop: recount on best {again}, in-run {seen['val'][best_epoch]}")

        # -- run 2: preempted at step 3, then resumed ---------------------------
        seen.update(steps=[], losses=[], val=[])
        trainer_cls.PreemptionGuard.should_checkpoint = lambda self, step: step == 3
        cut, cut_hist = train_cli.main(args("run2"))
        trainer_cls.PreemptionGuard.should_checkpoint = real[3]
        cut_meta = json.loads((tmp / "run2" / CLS_PRESET / "ckpt_1.meta.json").read_text())
        seen.update(steps=[], losses=[])
        resumed, _ = train_cli.main(args("run2", "--resume"))
        rlosses = [float(v) for v in seen["losses"]]
        emit({"phase": "cls_loop", "card": card, "run": "preempted at step 3, resumed",
              "cut_step": cut.step, "cut_meta": cut_meta, "restored_equal": seen["restored"],
              "resumed_losses": rlosses, "resumed_step": resumed.step})
        check(cut.step == 3 and cut_meta.get("preempted") is True and cut_hist["val_acc1"] == [],
              f"cls_loop: preemption gave step {cut.step}, meta {cut_meta}")
        check(len(seen["restored"]) == 1 and all(seen["restored"][0].values()),
              f"cls_loop: restore {seen['restored']}")
        check(resumed.step == 6 and len(rlosses) == 3 and all(np.isfinite(rlosses)),
              f"cls_loop: resumed to {resumed.step}, losses {rlosses}")
        del cut, resumed
        torch.cuda.empty_cache()
    finally:
        (trainer_cls.make_train_step, trainer_cls.evaluate_topk, trainer_cls._restore_state,
         trainer_cls.PreemptionGuard.should_checkpoint) = real

    try:
        # -- the loader alone, and per item its steps on one thread --------------
        kib = imagenet_like_jpegs(np, tmp / "loader" / "train", CLS_LOADER_ITEMS)
        ds = imagenet.ImageNetDataset(str(tmp / "loader"), "train", size=CLS_IMG)
        loader = DataLoader(ds, CLS_LOADER_BATCH, shuffle=True, drop_last=True, epoch=1)
        t0 = time.perf_counter()
        n = sum(len(b["label"]) for b in loader)
        loader_s = time.perf_counter() - t0
        parts = dict.fromkeys(("decode", "crop_resize", "flip", "rand_augment",
                               "jitter_normalise", "erasing"), 0.0)
        for idx, (path, _) in enumerate(ds.samples):  # train_transform_cls, step by step
            rng = random.Random(f"0:0:{idx}")
            steps = (("decode", lambda _: imread_rgb(path)),
                     ("crop_resize", lambda im: imagenet.random_resized_crop(im, rng, CLS_IMG)),
                     ("flip", lambda im: np.ascontiguousarray(im[:, ::-1])
                      if rng.random() < 0.5 else im),
                     ("rand_augment", lambda im: imagenet.rand_augment(im, rng)),
                     ("jitter_normalise", lambda im: imagenet.normalize(
                         imagenet.color_jitter(im, rng))),
                     ("erasing", lambda im: imagenet.random_erasing(im, rng)))
            img = None
            for name, fn in steps:
                t = time.perf_counter()
                img = fn(img)
                parts[name] += time.perf_counter() - t
        per_item = {k: v / len(ds) * 1e3 for k, v in parts.items()}
        emit({"phase": "cls_loop", "card": card, "run": "loader", "items": n,
              "sides": CLS_LOADER_SHAPES, "mean_file_kib": kib, "batch": CLS_LOADER_BATCH, "threads": loader.num_threads,
              "img_per_s": n / loader_s, "item_ms_one_thread": per_item,
              "item_ms_total": sum(per_item.values())})
        check(n == len(ds) // CLS_LOADER_BATCH * CLS_LOADER_BATCH, f"cls_loop: loader gave {n}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: launches[k] for k in ("deform_attn_fwd", "deform_attn_bwd")}


def imagenet_like_jpegs(np, train_dir, n, seed=0):
    """Write ``n`` JPEGs in three class folders under ``train_dir``, each
    one of ``CLS_LOADER_SHAPES`` (three in four landscape), with
    ImageNet-like entropy: a smooth colour field, noise at 4 px and noise
    per pixel, all from ``seed``. Returns the mean file size in KiB."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    total = 0
    for i in range(n):
        h, w = CLS_LOADER_SHAPES[int(rng.random() >= 0.75)]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
        img = np.empty((h, w, 3), np.float32)
        for c in range(3):
            fy, fx = rng.uniform(0.5, 4.0, 2)
            img[..., c] = 128 + 60 * np.sin(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6.3))
        coarse = rng.normal(0, 40, (h // 4 + 1, w // 4 + 1, 3)).astype(np.float32)
        img += np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:h, :w]
        img += rng.normal(0, 12, (h, w, 3)).astype(np.float32)
        d = train_dir / f"n{i % 3:03d}"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"synth_{i:03d}.JPEG"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            path, "JPEG", quality=CLS_LOADER_QUALITY)
        total += path.stat().st_size
    return total / n / 1024


# ---- 17. scale_out: the step over processes (parallel/mesh.py) ---------------
SCALE_BATCH = 4  # the global batch of the two-rank float32 step, 2 a rank
SCALE_IGNORED = 0.9  # the share of rank 1's pixels labelled 255 (rank 0's: 5%)
SCALE_TORCHRUN_ITERS = 4
LAUNCHER = "dat_segmentation_tpu_torch/tools/launch_multihost.sh"  # torchrun on one node
SCALE_SETS = ("schedule.warmup_iters=0", "checkpoint_interval=2", "eval_interval=4",
              "log_interval=1")


def scale_batch(np, mc):
    """The two-rank step's global batch: rank 1's rows (2, 3) mostly ignored."""
    rng = np.random.RandomState(SEED + 21)
    label = rng.randint(0, mc.num_classes, (SCALE_BATCH, IMG, IMG))
    label[rng.rand(SCALE_BATCH, IMG, IMG) < 0.05] = 255
    label[SCALE_BATCH // 2:][rng.rand(SCALE_BATCH // 2, IMG, IMG) < SCALE_IGNORED] = 255
    return {"image": rng.randn(SCALE_BATCH, IMG, IMG, 3).astype(np.float32), "label": label}


def scale_cfg(depths=None):
    """The preset as it is (drop path 0.3, dropout 0.1), float32, warm-up 0;
    the backbone cut to ``depths`` where given."""
    from dataclasses import replace

    from dat_segmentation_tpu_torch import get_config

    cfg = get_config(TRAIN_PRESET)
    if depths is not None:
        cfg = replace(cfg, model=replace(cfg.model, backbone=replace(cfg.model.backbone,
                                                                     depths=depths)))
    return replace(cfg, dtype="float32", schedule=replace(cfg.schedule, warmup_iters=0))


def dict_grad_compare(got, want):
    """||g - g_ref|| / ||g_ref|| over two name -> gradient dicts, and the names
    beyond TOL_GRAD_PARAM (grad_compare's rule)."""
    dsq = gsq = 0.0
    per = []
    for name, w in want.items():
        d, gn = (got[name].float() - w.float()).norm().item(), w.float().norm().item()
        dsq, gsq = dsq + d * d, gsq + gn * gn
        per.append((d, gn, name))
    off = [n for d, g, n in per if d > TOL_GRAD_PARAM * g + 1e-6 * gsq ** 0.5]
    return (dsq / gsq) ** 0.5, off


def leaves_beyond(got, want, rel, floor):
    """In float64: ||g - g_ref|| / ||g_ref|| over all leaves, and the names
    whose gradient differs by more than ``rel`` of its own norm plus
    ``floor`` of the whole gradient's."""
    per = [((got[n].double() - w.double()).norm().item(), w.double().norm().item(), n)
           for n, w in want.items()]
    total = sum(g * g for _, g, _ in per) ** 0.5
    diff = sum(d * d for d, _, _ in per) ** 0.5
    return diff / total, [n for d, g, n in per if d > rel * g + floor * total]


def params_rel(got, want):
    num = sum((got[n].float() - w.float()).norm().item() ** 2 for n, w in want.items())
    den = sum(w.float().norm().item() ** 2 for w in want.values())
    return (num / den) ** 0.5


def scale_rank(rank, world, tmp):
    """One of two gloo ranks on the one card (NCCL refuses two ranks on one
    GPU): the distributed eval, the float32 step, an fsdp step; the result
    to ``tmp/rank<r>.pt``. Spawned by ``scale_out_phase``."""
    import hashlib
    import os
    from dataclasses import replace

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dat_segmentation_tpu_torch import SegInferencer, build_model, create_train_state
    from dat_segmentation_tpu_torch import make_train_step
    from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
    from dat_segmentation_tpu_torch.eval.evaluate import evaluate_dataset
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.parallel import (destroy_distributed, init_distributed,
                                                     process_shard_info)
    from dat_segmentation_tpu_torch.parallel import mesh

    tmp = Path(tmp)
    dev = init_distributed("gloo", init_method=f"file://{tmp}/rendezvous")
    out = {"device": str(dev)}
    try:
        cfg = scale_cfg()
        mc = cfg.model
        # the distributed eval of the seed's weights, three images a rank
        torch.manual_seed(SEED)
        model = build_model(mc, device=dev)
        inf = SegInferencer(model, num_classes=mc.num_classes, compute_dtype=torch.float32,
                            device=dev)
        t0 = time.perf_counter()
        res = evaluate_dataset(inf, ADE20KDataset(str(tmp / "data"), "val"),
                               num_classes=mc.num_classes, shard_info=process_shard_info(),
                               distributed=True, verbose=False)
        out["eval"] = dict(inter=res["inter"], union=res["union"], mIoU=res["mIoU"],
                           num_images=res["num_images"], seconds=time.perf_counter() - t0)
        del inf
        # the float32 step on this rank's rows of the global batch
        n = SCALE_BATCH // world
        local = {k: torch.as_tensor(v[rank * n:(rank + 1) * n]).to(dev)
                 for k, v in scale_batch(np, mc).items()}
        state = create_train_state(model, cfg)
        step = make_train_step(model, aux_weight=mc.aux_loss_weight, num_classes=mc.num_classes,
                               compute_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.deform_attn.launches = da.deform_attn_bwd.launches = 0
        t0 = time.perf_counter()
        _, met = step(state, local)
        torch.cuda.synchronize()
        out["step"] = {"seconds": time.perf_counter() - t0,
                       "launches": {"deform_attn_fwd": da.deform_attn.launches,
                                    "deform_attn_bwd": da.deform_attn_bwd.launches},
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       **{k: v.cpu() for k, v in met.items()}}
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        out["step"]["params_sha256"] = digest.hexdigest()
        grads = {n_: p.grad.detach() for n_, p in model.named_parameters() if p.grad is not None}
        params = {n_: p.detach() for n_, p in model.named_parameters()}
        # fsdp over the two gloo ranks, if gloo's CUDA collectives carry it
        try:
            torch.manual_seed(SEED)
            fmodel = build_model(mc, device=dev)
            fstate = create_train_state(fmodel, replace(cfg, fsdp=True))
            fstep = make_train_step(fmodel, aux_weight=mc.aux_loss_weight,
                                    num_classes=mc.num_classes, compute_dtype=torch.float32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, fmet = fstep(fstate, local)
            torch.cuda.synchronize()
            # each rank's shards against the same rows of the replicated
            # parameters (gathering them, a DTensor redistribute, crashes in
            # gloo's CUDA path)
            shards = {n_: mesh.local(p) for n_, p in fmodel.named_parameters()}
            rows = {n_: (list(p.chunk(world, dim=0)) + [p[:0]] * world)[rank]
                    for n_, p in params.items()}
            out["fsdp"] = {"loss": fmet["loss"].item(),
                           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                           "params_rel_vs_replicated": params_rel(shards, rows),
                           "sharded": {n_: [list(s.shape), list(params[n_].shape)]
                                       for n_, s in list(shards.items())[:1]}}
            del fmodel, fstate, fstep, shards, rows
        except RuntimeError as e:  # only the backend's refusal is an answer
            if "gloo" not in str(e).lower() and "not supported" not in str(e).lower():
                raise
            out["fsdp"] = {"unsupported": str(e)[:400]}
        # against the one-process step, once the parent has written it
        ref_path = tmp / "ref.pt"
        end = time.time() + 300
        while not (tmp / "ref.done").exists():
            if time.time() > end:
                raise TimeoutError("no one-process reference")
            time.sleep(0.2)
        ref = torch.load(ref_path, map_location=dev, weights_only=True)
        out["vs_one_process"] = {
            "loss_rel_err": abs(met["loss"].item() - ref["loss"].item()) / abs(ref["loss"].item()),
            "grad": dict_grad_compare(grads, ref["grads"]),
            "params_rel_err": params_rel(params, ref["params"]),
            "iou_count_abs_diff": int((met["inter"] - ref["inter"]).abs().sum()
                                      + (met["union"] - ref["union"]).abs().sum()),
        }
    finally:
        destroy_distributed()
    torch.save(out, tmp / f"rank{rank}.pt")


def free_port() -> int:
    """A localhost port that is free now, the first below the kernel's
    ephemeral range (``ip_local_port_range``; it may start as low as
    16000): a port from the range (a bind to port 0) is also handed to
    other sockets' connects and binds, so it can be taken before torchrun
    binds it (EADDRINUSE); below the range only an explicit bind takes a
    port."""
    import socket

    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    for port in range(low - 1, 1023, -1):
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free localhost port below {low}")


def fixture_layout(root, copies):
    """The fixture's six images (and masks), each ``copies`` times, as the
    train split, and once as the val split, under ``root``."""
    import shutil

    src = Path(__file__).resolve().parent / EVAL_DATA
    for split, n in (("training", copies), ("validation", 1)):
        for kind, suffix in (("images", ".jpg"), ("annotations", ".png")):
            d = root / kind / split
            d.mkdir(parents=True)
            for p in sorted((src / kind / "validation").glob(f"*{suffix}")):
                for c in range(n):
                    shutil.copy(p, d / (p.name if n == 1 else f"{p.stem}_{c}{suffix}"))
    return root


def scale_out_start(torch, np, dev):
    """17. scale_out, started early (``main`` runs phases that time nothing
    beside it): the fixture's splits, two gloo ranks (``scale_rank``), the
    train CLI under torchrun by the launcher (one NCCL rank), and here the
    one-process references the ranks wait for (the eval and the float32
    step on the whole global batch). Returns the run's state for
    ``scale_out_wait``, ``scale_out_stop`` and ``scale_out_phase``."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    from dat_segmentation_tpu_torch import SegInferencer, build_model, create_train_state
    from dat_segmentation_tpu_torch import make_train_step
    from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
    from dat_segmentation_tpu_torch.eval.evaluate import evaluate_dataset

    # float32 parity against the gloo ranks (which turn TF32 off too)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = {"t0": time.perf_counter(), "tmp": Path(tempfile.mkdtemp(prefix="scale_out_")),
           "ctx": None, "cli": None, "cli_rc": None, "cli_s": None, "waited_s": None}
    tmp = run["tmp"]
    try:
        fixture_layout(tmp / "data", LOOP_COPIES)
        torch.cuda.empty_cache()
        run["ctx"] = mp.start_processes(scale_rank, args=(2, str(tmp)), nprocs=2,
                                        start_method="spawn", join=False)
        # the train CLI under torchrun, one NCCL rank, by the launcher
        cmd = ["bash", LAUNCHER, TRAIN_PRESET, str(tmp / "data"), "--work-dir",
               str(tmp / "torchrun"), "--max-iters", str(SCALE_TORCHRUN_ITERS), "--set",
               *SCALE_SETS]
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "NODE_RANK", "MASTER_ADDR"):
            env.pop(k, None)
        # the launcher runs python3 from PATH: this interpreter's
        env.update(NNODES="1", GPUS_PER_NODE="1", MASTER_PORT=str(free_port()),
                   PATH=f"{Path(sys.executable).parent}:{env.get('PATH', '')}")
        t_cli = time.perf_counter()
        with open(tmp / "torchrun.err", "w") as err:
            cli = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err, env=env,
                                   cwd=Path(__file__).resolve().parent, start_new_session=True)
        run.update(cmd=cmd, cli=cli)

        def watch():  # the CLI's exit code and seconds, when it ends
            run["cli_rc"] = cli.wait()
            run["cli_s"] = time.perf_counter() - t_cli

        run["cli_watch"] = threading.Thread(target=watch, daemon=True)
        run["cli_watch"].start()
        run["t_cli"] = t_cli
        # the one-process step on the whole global batch (no group), meanwhile
        cfg = scale_cfg()
        mc = cfg.model
        torch.manual_seed(SEED)
        model = build_model(mc, device=dev)
        inf = SegInferencer(model, num_classes=mc.num_classes, compute_dtype=torch.float32,
                            device=dev)
        run["one_eval"] = evaluate_dataset(inf, ADE20KDataset(str(tmp / "data"), "val"),
                                           num_classes=mc.num_classes, verbose=False)
        del inf
        state = create_train_state(model, cfg)
        step = make_train_step(model, aux_weight=mc.aux_loss_weight,
                               num_classes=mc.num_classes, compute_dtype=torch.float32)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in scale_batch(np, mc).items()}
        _, met = step(state, batch)
        torch.save({"loss": met["loss"], "inter": met["inter"], "union": met["union"],
                    "grads": {n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None},
                    "params": dict(model.named_parameters())}, tmp / "ref.pt")
        (tmp / "ref.done").touch()
        run["one_loss"] = met["loss"].item()
        del model, state, step, batch, met
        torch.cuda.empty_cache()
    except BaseException:
        scale_out_stop(run)
        raise
    return run


def scale_out_stop(run) -> None:
    """Kill what of ``scale_out_start``'s run still runs and remove its
    files; again at once."""
    import os
    import shutil

    if run["ctx"] is not None:
        for p in run["ctx"].processes:
            if p.is_alive():
                p.kill()
    cli = run["cli"]
    if cli is not None and cli.poll() is None:
        os.killpg(cli.pid, signal.SIGKILL)
        cli.wait()
    shutil.rmtree(run["tmp"], ignore_errors=True)


def scale_out_wait(run) -> None:
    """Wait for ``scale_out_start``'s gloo ranks (killed, and a
    ``TimeoutError``, 600 s after the start) and its torchrun CLI (killed
    400 s after its start); at once if done."""
    import os

    if run["waited_s"] is not None:
        return
    try:
        end = run["t0"] + 600
        while not run["ctx"].join(timeout=5):
            if time.perf_counter() > end:
                raise TimeoutError("scale_out: the two ranks still run after 600 s")
        run["cli_watch"].join(timeout=max(1.0, 400 - (time.perf_counter() - run["t_cli"])))
        if run["cli_watch"].is_alive():
            os.killpg(run["cli"].pid, signal.SIGKILL)
            run["cli_watch"].join()
    except BaseException:
        scale_out_stop(run)
        raise
    run["waited_s"] = time.perf_counter() - run["t0"]


def scale_out_phase(torch, np, card, dev, n_d, timed, started):
    """17. scale_out (see the module docstring) on ``scale_out_start``'s
    run: its lines and gates, then the NCCL rank in this process. Returns
    K1's and K2's launches in rank 0's step of the two-rank run (counts set
    to 0 just before, in that process)."""
    import os
    from dataclasses import replace

    from dat_segmentation_tpu_torch import build_model, create_train_state, make_train_step
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.parallel import destroy_distributed, init_distributed
    from dat_segmentation_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    tmp = started["tmp"]
    try:
        scale_out_wait(started)
        cfg = scale_cfg()
        mc = cfg.model
        one_eval, one_loss = started["one_eval"], started["one_loss"]
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
        r0, r1 = ranks
        rel = [r["vs_one_process"] for r in ranks]
        emit({"phase": "scale_out", "card": card, "part": "two gloo ranks on one card",
              "preset": TRAIN_PRESET, "dtype": "float32", "tf32": False,
              "global_batch": SCALE_BATCH, "rank1_ignored_share": SCALE_IGNORED,
              "drop_path_rate": mc.backbone.drop_path_rate,
              "devices": [r["device"] for r in ranks],
              "loss": [r["step"]["loss"].item() for r in ranks], "loss_one_process": one_loss,
              "loss_rel_err": [v["loss_rel_err"] for v in rel],
              "grad_rel_err": [v["grad"][0] for v in rel],
              "grads_beyond_tol": [v["grad"][1] for v in rel],
              "params_rel_err": [v["params_rel_err"] for v in rel],
              "iou_count_abs_diff": [v["iou_count_abs_diff"] for v in rel],
              "pixels": SCALE_BATCH * IMG * IMG,
              "replicas_equal": r0["step"]["params_sha256"] == r1["step"]["params_sha256"],
              "launches_per_rank": [r["step"]["launches"] for r in ranks],
              "step_s": [r["step"]["seconds"] for r in ranks],
              "peak_gib_replicated": [r["step"]["peak_gib"] for r in ranks],
              "fsdp": [r["fsdp"] for r in ranks],
              "tol": {"loss": TOL_TRAIN_LOSS, "grad": TOL_GRAD, "params": TOL_GRAD,
                      "grad_param": TOL_GRAD_PARAM}})
        for r, (rank, v) in enumerate(zip(ranks, rel)):
            what = f"scale_out rank {r}"
            check(v["loss_rel_err"] <= TOL_TRAIN_LOSS,
                  f"{what}: loss rel err {v['loss_rel_err']} > {TOL_TRAIN_LOSS}")
            check(v["grad"][0] <= TOL_GRAD, f"{what}: grad rel err {v['grad'][0]} > {TOL_GRAD}")
            check(not v["grad"][1], f"{what}: gradients beyond {TOL_GRAD_PARAM}: {v['grad'][1]}")
            check(v["params_rel_err"] <= TOL_GRAD,
                  f"{what}: params rel err {v['params_rel_err']} > {TOL_GRAD}")
            # argmax near-ties may flip under float32 rounding (train_model's rule)
            check(v["iou_count_abs_diff"] <= 1e-4 * SCALE_BATCH * IMG * IMG,
                  f"{what}: IoU counts differ by {v['iou_count_abs_diff']}")
            check(rank["step"]["launches"] == {"deform_attn_fwd": n_d, "deform_attn_bwd": n_d},
                  f"{what}: launches {rank['step']['launches']}, want {n_d} each")
            if "unsupported" not in rank["fsdp"]:
                check(abs(rank["fsdp"]["loss"] - rank["step"]["loss"].item())
                      <= TOL_TRAIN_LOSS * abs(one_loss)
                      and rank["fsdp"]["params_rel_vs_replicated"] <= TOL_GRAD,
                      f"{what}: fsdp vs replicated {rank['fsdp']}")
        check(r0["step"]["params_sha256"] == r1["step"]["params_sha256"],
              "scale_out: the two ranks' parameters differ")
        for r, rank in enumerate(ranks):
            ev = rank["eval"]
            check(ev["inter"] == one_eval["inter"] and ev["union"] == one_eval["union"]
                  and ev["num_images"] == one_eval["num_images"] == 6,
                  f"scale_out rank {r}: distributed eval counts differ from one process's")
        emit({"phase": "scale_out", "card": card, "part": "evaluate_dataset(distributed=True)",
              "ranks": 2, "backend": "gloo", "images": one_eval["num_images"],
              "mIoU": [r["eval"]["mIoU"] for r in ranks], "mIoU_one_process": one_eval["mIoU"],
              "counts_equal": [r["eval"]["inter"] == one_eval["inter"]
                               and r["eval"]["union"] == one_eval["union"] for r in ranks],
              "seconds": [r["eval"]["seconds"] for r in ranks]})

        rc, cli_s, cmd = started["cli_rc"], started["cli_s"], started["cmd"]
        run_dir = tmp / "torchrun" / TRAIN_PRESET
        log = (run_dir / "train.log").read_text() if (run_dir / "train.log").exists() else ""
        losses = [float(x) for x in re.findall(r"loss=([-0-9.naif]+)", log)]
        names = sorted(p.name for p in run_dir.glob("ckpt_*")) if run_dir.exists() else []
        emit({"phase": "scale_out", "card": card, "part": "torchrun train CLI, one NCCL rank",
              "command": "NNODES=1 GPUS_PER_NODE=1 " + " ".join(cmd[:3]) + " ...",
              "rc": rc, "seconds": cli_s, "beside": "the gloo ranks and phases 3-4, 7",
              "losses": losses,
              "checkpoints": names, "val_lines": [ln for ln in log.splitlines() if "val mIoU" in ln],
              "stderr_tail": (tmp / "torchrun.err").read_text()[-1500:] if rc else ""})
        check(rc == 0, f"scale_out: torchrun train CLI rc {rc}")
        check(len(losses) == SCALE_TORCHRUN_ITERS and all(np.isfinite(losses)),
              f"scale_out: torchrun losses {losses}")
        check({"ckpt_2", "ckpt_4", "ckpt_best"} <= set(names),
              f"scale_out: torchrun checkpoints {names}")
        check(any("val mIoU" in ln for ln in log.splitlines()), "scale_out: no in-run val")

        mark("17. scale_out: one NCCL rank")
        # -- one NCCL rank in this process: fsdp against replicated, the cost
        # of the machinery against the plain step, the gradient all-reduce --
        def join():
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                              MASTER_PORT=str(free_port()))
            return init_distributed()

        join()
        backend = torch.distributed.get_backend()
        b2 = {k: torch.as_tensor(v[:2]).to(dev) for k, v in scale_batch(np, mc).items()}
        runs = {}
        for name, fsdp in (("replicated", False), ("fsdp", True)):
            torch.manual_seed(SEED)
            m = build_model(mc, device=dev)
            st = create_train_state(m, replace(cfg, fsdp=fsdp))
            stp = make_train_step(m, aux_weight=mc.aux_loss_weight, num_classes=mc.num_classes,
                                  compute_dtype=torch.float32)
            _, mt = stp(st, b2)
            torch.cuda.synchronize()
            runs[name] = (mt["loss"].item(), {n: mesh.local(p.grad).detach()
                                              for n, p in m.named_parameters()
                                              if p.grad is not None})
            del m, st, stp, mt
        loss_rel = abs(runs["fsdp"][0] - runs["replicated"][0]) / abs(runs["replicated"][0])
        grad_rel, off = dict_grad_compare(runs["fsdp"][1], runs["replicated"][1])
        emit({"phase": "scale_out", "card": card, "part": "fsdp vs replicated, one NCCL rank",
              "backend": backend, "dtype": "float32", "batch": 2,
              "loss": {k: v[0] for k, v in runs.items()}, "loss_rel_err": loss_rel,
              "grad_rel_err": grad_rel, "grads_beyond_tol": off})
        check(backend == "nccl", f"scale_out: backend {backend}, want nccl")
        check(loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_GRAD and not off,
              f"scale_out: fsdp vs replicated under NCCL: loss {loss_rel}, grad {grad_rel}, {off}")
        del runs
        torch.cuda.empty_cache()

        bcfg = replace(cfg, dtype="bfloat16")
        rng = np.random.RandomState(SEED + 22)
        b16 = {"image": torch.tensor(rng.randn(TRAIN_BATCH, IMG, IMG, 3), dtype=torch.float32,
                                     device=dev),
               "label": torch.tensor(rng.randint(0, mc.num_classes, (TRAIN_BATCH, IMG, IMG)),
                                     device=dev)}
        torch.manual_seed(SEED)
        model = build_model(mc, device=dev)
        state = create_train_state(model, bcfg)
        kw = dict(aux_weight=mc.aux_loss_weight, num_classes=mc.num_classes,
                  compute_dtype=torch.bfloat16)
        dist_step = make_train_step(model, **kw)
        torch.cuda.synchronize()
        da.deform_attn.launches = da.deform_attn_bwd.launches = 0
        dist_step(state, b16)
        torch.cuda.synchronize()
        nccl_launches = {"deform_attn_fwd": da.deform_attn.launches,
                         "deform_attn_bwd": da.deform_attn_bwd.launches}
        check(nccl_launches == {"deform_attn_fwd": n_d, "deform_attn_bwd": n_d},
              f"scale_out: NCCL bf16 step launches {nccl_launches}")
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        reduce_ms = timed(lambda: mesh.reduce_gradients(grads), 10)
        torch.cuda.reset_peak_memory_stats()
        dist_step(state, b16)
        torch.cuda.synchronize()
        peak_rep = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = {"distributed": [], "plain": []}
        plain_step = None
        for turn in ("distributed", "plain", "plain", "distributed"):
            if turn == "plain" and mesh.is_distributed():
                destroy_distributed()
                plain_step = plain_step or make_train_step(model, **kw)
            if turn == "distributed" and not mesh.is_distributed():
                join()
            fn = dist_step if turn == "distributed" else plain_step
            ms[turn].append(timed(lambda: fn(state, b16), TIME_STEPS, warmup=1))
        med = {k: statistics.median(v) for k, v in ms.items()}
        # where the machinery's time goes: each step's device time by kernel
        profiles = {"distributed": profile_device(torch, lambda: dist_step(state, b16), card,
                                                  med["distributed"], "step", iters=2)}
        destroy_distributed()
        profiles["plain"] = profile_device(torch, lambda: plain_step(state, b16), card,
                                           med["plain"], "step", iters=2)
        join()
        for name, prof in profiles.items():
            emit(dict(prof, part=f"scale_out, one NCCL rank: the {name} step", batch=TRAIN_BATCH))
        del model, state, dist_step, plain_step, grads
        torch.cuda.empty_cache()
        torch.manual_seed(SEED)
        fmodel = build_model(mc, device=dev)
        fstate = create_train_state(fmodel, replace(bcfg, fsdp=True))
        fstep = make_train_step(fmodel, **kw)
        fsdp_loss = fstep(fstate, b16)[1]["loss"].item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fstep(fstate, b16)
        torch.cuda.synchronize()
        peak_fsdp = torch.cuda.max_memory_allocated() / 2 ** 30
        del fmodel, fstate, fstep
        torch.cuda.empty_cache()
        # fsdp with use_checkpoint: each stage's recompute on the parameters
        # FSDP2 gathers again before its backward
        ckmc = replace(mc, backbone=replace(mc.backbone, use_checkpoint=True))
        torch.manual_seed(SEED)
        fmodel = build_model(ckmc, device=dev)
        fstate = create_train_state(fmodel, replace(bcfg, model=ckmc, fsdp=True))
        fstep = make_train_step(fmodel, **kw)
        torch.cuda.synchronize()
        da.deform_attn.launches = da.deform_attn_bwd.launches = 0
        ck_loss = fstep(fstate, b16)[1]["loss"].item()
        torch.cuda.synchronize()
        ck_launches = (da.deform_attn.launches, da.deform_attn_bwd.launches)
        torch.cuda.reset_peak_memory_stats()
        fstep(fstate, b16)
        torch.cuda.synchronize()
        peak_fsdp_ck = torch.cuda.max_memory_allocated() / 2 ** 30
        del fmodel, fstate, fstep
        ck_rel = abs(ck_loss - fsdp_loss) / abs(fsdp_loss)
        check(ck_launches == (2 * n_d, n_d) and ck_rel <= TOL_TRAIN_LOSS,
              f"scale_out: fsdp with use_checkpoint: launches {ck_launches}, want "
              f"{(2 * n_d, n_d)}; loss {ck_loss} against fsdp's {fsdp_loss}")
        destroy_distributed()
        torch.cuda.empty_cache()
        device_ms = {k: v.get("device_ms_per_step") for k, v in profiles.items()}
        emit({"phase": "scale_out", "card": card, "part": "one NCCL rank, bf16 step",
              "preset": TRAIN_PRESET, "batch": TRAIN_BATCH, "order": "dist plain plain dist",
              "ms_per_step": ms, "median_ms_per_step": med,
              "machinery_ms": med["distributed"] - med["plain"],
              "machinery_share": med["distributed"] / med["plain"] - 1,
              "device_ms_per_step": device_ms,
              "device_machinery_ms": (device_ms["distributed"] - device_ms["plain"]
                                      if None not in device_ms.values() else "not measured"),
              "gradient_all_reduce_ms": reduce_ms, "gradient_bytes": grad_bytes,
              "gradient_buckets": -(-grad_bytes // mesh.BUCKET_BYTES),
              "peak_gib": {"replicated": peak_rep, "fsdp": peak_fsdp,
                           "fsdp_use_checkpoint": peak_fsdp_ck},
              "fsdp_use_checkpoint": {"launches_step1": ck_launches, "loss_step1": ck_loss,
                                      "loss_step1_fsdp": fsdp_loss, "loss_rel": ck_rel},
              "note": "world 1: NCCL reduces over one card; NCCL across cards is unmeasured"})

    finally:
        scale_out_stop(started)
    emit({"phase": "scale_out", "card": card, "seconds": time.perf_counter() - t_phase,
          "started_s_before": t_phase - started["t0"],
          "ranks_and_cli_s_to_the_wait": started["waited_s"]})
    return r0["step"]["launches"]


# ---- 17b. model_axis: tensor parallelism over the mesh's model axis ----------
AXIS_ROWS = (0, SCALE_BATCH - 1)  # scale_batch's rows: data coordinate 1's 90% ignored
AXIS_MESHES = (({"data": 1, "model": 2}, ("auto", "pallas", "float64", "modes")),
               ({"data": 2, "model": 2}, ("auto",)))
# the modes leg's position-bias mode a stage: stage 0's continuous bias (one
# offset group: whole, K1 and K2), the composite on stages 1-3, split by group
AXIS_MODES = ("continuous", "dwc_pe", "log_cpb", "fixed_pe")
JAX_MIN_SIZE = 2 ** 14  # the JAX fsdp_sharding's min_size
JAX_SHARE_SLACK = 0.005  # a rank's bytes share may exceed the JAX rule's by this much
# The model and spatial axis phases run the flagship at full width and this
# depth (every stage with both block kinds, every split of the attention:
# 5 'D' blocks, 8 in all), against one-process references at the same
# depth, so that the whole script keeps inside its time with the full_mesh
# phase, which runs the full depth.
AXIS_DEPTHS = (2, 2, 2, 2)
AXIS_MAX_SHARE = 0.60  # a rank's parameter + AdamW bytes over the whole model's
# The split step's float32 gradients are not comparable leaf by leaf with the
# one-process step's at full size: the split products sum in another order,
# which moves a sample position by about 4e-7 relative, and a bilinear sample
# that close to a cell edge takes the other cell's slope; one such sample
# moves every gradient upstream of its block by percents
# (dat_segmentation_tpu_torch/tools/axis_probe.py finds them on this batch).
# So the float32 legs hold the loss, the parameters and the counts at
# scale_out's gates and report the gradients; the float64 leg (the attention
# by its plain version: K1 and K2 take float32 and bf16) holds every
# gradient, where rounding moves a position by 1e-16: globally and per leaf,
# as grad_compare's rule.
TOL_AXIS_F64_GRAD = 1e-9
TOL_AXIS_F64_LEAF = 1e-6


def jax_rule_share(model, size):
    """The share of ``model``'s parameter bytes that one device holds under
    the JAX package's ``fsdp_sharding`` over an axis of ``size`` (a leaf of
    ``JAX_MIN_SIZE`` elements or more with a dim that divides by ``size``
    sharded, the rest replicated): computed here, as the card has no JAX.
    AdamW's moments follow their parameters, so it is their share too."""
    whole = held = 0
    for p in model.parameters():
        nbytes = p.numel() * p.element_size()
        shard = p.numel() >= JAX_MIN_SIZE and any(d % size == 0 for d in p.shape)
        whole += nbytes
        held += nbytes / size if shard else nbytes
    return held / whole


def axis_batch(np, mc):
    """The split steps' global batch of two: one row of each of scale_batch's
    halves."""
    return {k: v[list(AXIS_ROWS)] for k, v in scale_batch(np, mc).items()}


def mesh_leg(name, fsdp, mesh, check=False, depths=None):
    """A leg of the mesh phases: the step ``name`` on ``mesh`` with ``fsdp``
    at the backbone's ``depths`` (None: the preset's). 'pallas' runs K3,
    'float64' the step in float64 with the attention's plain version,
    'ckpt' and 'fsdp_ckpt' ``use_checkpoint``, 'modes' the stages in
    ``AXIS_MODES``; ``check``: ``mesh_rank``'s."""
    return {"key": f"{name} {mesh_tag(mesh)}", "name": name, "mesh": mesh, "fsdp": fsdp,
            "impl": "pallas" if name == "pallas" else "auto", "depths": depths,
            "ckpt": name in ("ckpt", "fsdp_ckpt"), "check": check,
            "modes": AXIS_MODES if name == "modes" else None}


def ref_impl(leg):
    """The one-process reference (``axis_refs``' impl) a leg is held to."""
    return leg["name"] if leg["name"] in ("float64", "modes") else leg["impl"]


def mesh_tag(mesh):
    return "x".join(f"{k}{v}" for k, v in mesh.items())


def ref_path(tmp, impl, depths):
    """The one-process reference ``axis_refs`` writes for ``impl`` at
    ``depths``."""
    return Path(tmp) / f"ref_{impl}{'' if depths is None else '_' + ''.join(map(str, depths))}.pt"


def mesh_rank(rank, world, tmp, tag, legs):
    """One of ``world`` gloo ranks on the card: per leg (``mesh_leg``) one
    step of the flagship on the leg's mesh, on this data coordinate's rows
    (each spatial peer keeps its image rows), against the one-process step
    (``ref_path``, waited for), the K1, K2 and K3 launches, each K1 call's (B·g, H),
    the rows each fetch added to the peer's own and the bytes each exchange
    received, this rank's coordinates, parameter and AdamW bytes and peak
    memory; a split model's state and gradients gathered whole, a sharded
    one's shards against the same rows of the one-process tensors (a
    DTensor gather over gloo with CUDA tensors crashes: scale_out's note).
    A leg with ``check`` holds each K1 launch ('auto') or K3 launch
    ('pallas') against the plain version on its inputs, and a K2 launch at
    each K1 launch's shapes on drawn inputs (FULL_MESH_LEGS' note; not
    counted among the launches). The result to ``tmp/<tag>rank<r>.pt``.
    Spawned by ``axis_start`` for the model_axis, spatial_axis and full_mesh
    phases."""
    import collections
    import gc
    import hashlib
    import os
    from dataclasses import replace

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dat_segmentation_tpu_torch import build_model, create_train_state, make_train_step
    from dat_segmentation_tpu_torch.models import deformable_attention as dattn
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.ops import x_block as xb
    from dat_segmentation_tpu_torch.parallel import destroy_distributed, init_distributed, mesh
    from dat_segmentation_tpu_torch.parallel import spatial

    tmp = Path(tmp)
    dev = init_distributed("gloo", init_method=f"file://{tmp}/rendezvous_{tag}")
    out = {"joined_at": time.time()}
    calls, halos, received = [], collections.Counter(), [0, 0]
    route, fetch, exchange = dattn.deform_attn, spatial.fetch, spatial.exchange
    xb_forward = xb.XBlockFunction.forward
    real_attn = route
    vs_plain = {}  # kernel -> the largest max |kernel - plain| / max |plain| of this leg
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def worst(kernel, got, want):
        rel = (got.float() - want.float()).abs().max().item() / max(
            want.float().abs().max().item(), 1e-12)
        vs_plain[kernel] = max(vs_plain.get(kernel, 0.0), rel)

    def attn(q, *a, **k):
        calls.append((q.shape[0], q.shape[1]))
        out = real_attn(q, *a, **k)
        if checking == "auto":
            # K1 on this launch's inputs; K2 at its shapes on drawn inputs
            # (FULL_MESH_LEGS' note says why not on these)
            ins = [t.detach() for t in (q,) + a]
            drawn = [torch.randn(t.shape, generator=gen, device=dev, dtype=t.dtype)
                     for t in (q,) + a[:2]]
            drawn += [torch.rand(a[2].shape, generator=gen, device=dev) * 2 - 1,
                      torch.randn(a[3].shape, generator=gen, device=dev) * 0.02]
            dout = torch.randn(out.shape, generator=gen, device=dev, dtype=out.dtype)
            with torch.no_grad():
                worst("deform_attn_fwd", out.detach(), da.deform_attn_reference(*ins, **k))
                held = (da.deform_attn.launches, da.deform_attn_bwd.launches)
                got = da.deform_attn_bwd(*drawn, dout, **k)
                da.deform_attn.launches, da.deform_attn_bwd.launches = held
                for g, w in zip(got, da.deform_attn_bwd_reference(*drawn, dout, **k)):
                    worst("deform_attn_bwd", g, w)
        return out

    def k3_forward(ctx, x, *params_and_lpu):
        out = xb_forward(ctx, x, *params_and_lpu)
        if checking == "pallas":
            *params, with_lpu = params_and_lpu
            with torch.no_grad():
                worst("x_block_fwd", out, xb.x_block_reference(x, *params, with_lpu=with_lpu))
        return out

    def counted_fetch(x, rows, want):
        lo, hi = want(rows.axis.rank)
        halos[(hi - lo) - rows.n] += 1
        return fetch(x, rows, want)

    def counted_exchange(pieces, shapes, axis):
        received[0] += 1
        received[1] += sum(int(np.prod(sh)) for t, sh in enumerate(shapes)
                           if t != axis.rank) * pieces[0].element_size()
        return exchange(pieces, shapes, axis)

    def nbytes(tensors):
        return sum(mesh.local(t).numel() * t.element_size() for t in tensors)

    def run_leg(leg):  # its tensors die with it: the next leg's peak holds none of them
        nonlocal checking, real_attn
        impl, fsdp = leg["impl"], leg["fsdp"]
        f64 = leg["name"] == "float64"
        checking = impl if leg["check"] else None
        vs_plain.clear()
        t_leg = time.perf_counter()
        cfg = scale_cfg(leg["depths"])
        mc = replace(cfg.model, backbone=replace(cfg.model.backbone, kernel_impl=impl,
                                                 use_checkpoint=leg["ckpt"]))
        if leg["modes"]:
            mc = with_modes(mc, leg["modes"])
        cfg = replace(cfg, model=mc, fsdp=fsdp, mesh_shape=leg["mesh"])
        real_attn = da.deform_attn_reference if f64 else route
        torch.manual_seed(SEED)
        model = build_model(mc, device=dev)
        if f64:
            model.double()
        state = create_train_state(model, cfg)
        lay = mesh.layout()
        d, X = mesh.process_shard_info()
        n = len(AXIS_ROWS) // X
        local = {k: torch.as_tensor(v[d * n:(d + 1) * n]).to(dev)
                 for k, v in axis_batch(np, mc).items()}
        step = make_train_step(model, aux_weight=mc.aux_loss_weight,
                               num_classes=mc.num_classes,
                               compute_dtype=torch.float64 if f64 else torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.deform_attn.launches = da.deform_attn_bwd.launches = xb.x_block_fwd.launches = 0
        calls.clear()
        halos.clear()
        received[:] = [0, 0]
        t0 = time.perf_counter()
        _, met = step(state, local)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = {"seconds": t1 - t0, "setup_s": t0 - t_leg, "device": str(dev),
               "coords": (lay.data_rank, lay.model_rank, lay.spatial_rank),
               "launches": {"deform_attn_fwd": da.deform_attn.launches,
                            "deform_attn_bwd": da.deform_attn_bwd.launches,
                            "x_block_fwd": xb.x_block_fwd.launches},
               "k1_calls": list(calls),
               "kernel_vs_plain": dict(vs_plain),
               "halo_rows_per_fetch": dict(sorted(halos.items())),
               "exchanges": {"forward_calls": received[0],
                             "forward_bytes_from_peers": received[1]},
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "param_bytes": nbytes(model.parameters()),
               "adamw_bytes": nbytes([t for s in state.optimizer.state.values()
                                      for t in s.values() if torch.is_tensor(t) and t.ndim])}
        path = ref_path(tmp, ref_impl(leg), leg["depths"])
        end = time.time() + 300
        while not path.with_suffix(".done").exists():
            if time.time() > end:
                raise TimeoutError(f"no one-process reference {path.name}")
            time.sleep(0.2)
        ref = torch.load(path, map_location=dev, weights_only=True)
        stats = {n_: b for n_, b in model.named_buffers() if n_ in ref["stats"]}
        if mesh.is_sharded(model):  # this rank's shards against the same rows of the whole
            parts, s = ((lay.spatial, lay.spatial_rank) if model.fsdp_axis == "spatial"
                        else (lay.data, lay.data_rank))

            def part(t):
                return (list(t.chunk(parts, dim=0)) + [t[:0]] * parts)[s]

            params = {n_: mesh.local(p).detach() for n_, p in model.named_parameters()}
            grads = {n_: mesh.local(p.grad) for n_, p in model.named_parameters()}
            want_p = {n_: part(t) for n_, t in ref["params"].items()}
            want_g = {n_: part(ref["grads"][n_]) for n_ in grads}
        else:  # split leaves gathered whole
            axis, dims = mesh.model_axis_of(model), getattr(model, "model_axis_dims", {})
            grads = {n_: (mesh.gather_tensor(p.grad, dims[n_], axis) if n_ in dims
                          else p.grad) for n_, p in model.named_parameters()}
            whole = mesh.full_state(model, everywhere=True)[0]
            params = {n_: whole[n_] for n_, _ in model.named_parameters()}
            stats = {n_: whole[n_] for n_ in ref["stats"]}
            want_p, want_g = ref["params"], ref["grads"]
        digest = hashlib.sha256()
        for t in list(params.values()) + list(stats.values()):
            digest.update(t.detach().cpu().numpy().tobytes())
        res["state_sha256"] = digest.hexdigest()
        res["vs_one_process"] = {
            "loss": met["loss"].item(),
            "loss_rel_err": abs(met["loss"].item() - ref["loss"].item()) / abs(
                ref["loss"].item()),
            "grad": dict_grad_compare(grads, want_g),
            "grad_f64": leaves_beyond(grads, want_g, TOL_AXIS_F64_LEAF, TOL_AXIS_F64_GRAD),
            "params_rel_err": params_rel(params, want_p),
            "bn_max_abs_err": max((stats[n_].double() - b.double()).abs().max().item()
                                  for n_, b in ref["stats"].items()),
            "iou_count_abs_diff": int((met["inter"] - ref["inter"]).abs().sum()
                                      + (met["union"] - ref["union"]).abs().sum()),
        }
        res["compare_s"] = time.perf_counter() - t1
        return res

    checking = None
    dattn.deform_attn, spatial.fetch, spatial.exchange = attn, counted_fetch, counted_exchange
    xb.XBlockFunction.forward = staticmethod(k3_forward)
    try:
        for leg in legs:
            out[leg["key"]] = run_leg(leg)
            gc.collect()  # FSDP2's hooks hold the model in reference cycles
            torch.cuda.empty_cache()
    finally:
        dattn.deform_attn, spatial.fetch, spatial.exchange = route, fetch, exchange
        xb.XBlockFunction.forward = staticmethod(xb_forward)
        destroy_distributed()
    torch.save(out, tmp / f"{tag}rank{rank}.pt")


def axis_refs(torch, np, dev, tmp, depths=None, modes=False):
    """The one-process float32 ('auto', 'pallas') and float64 steps of the
    flagship at ``depths`` (None: the preset's) on ``axis_batch``, with
    ``modes`` also the float32 step with the stages in ``AXIS_MODES``
    ('modes'), each written to ``ref_path`` (then ``.done``) for the mesh
    phases' ranks; returns per impl the
    loss, peak memory, parameter and AdamW bytes, the model axis plan's
    parameter share at Y = 2 and the JAX rule's (``jax_rule_share``); and
    under "auto_one_image" the peak of the
    'auto' step on the batch's first image alone (the pixels a rank of
    {data: 1, spatial: 2} holds). A peak leaves out what this process held
    before (earlier phases' tensors), as a rank's fresh process holds
    nothing else."""
    from dataclasses import replace

    from dat_segmentation_tpu_torch import build_model, create_train_state, make_train_step
    from dat_segmentation_tpu_torch.models import deformable_attention as dattn
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.parallel.model_axis import model_axis_plan

    cfg = scale_cfg(depths)
    mc = cfg.model
    route = dattn.deform_attn
    whole = {}
    held = torch.cuda.memory_allocated()
    batch = {k: torch.as_tensor(v).to(dev) for k, v in axis_batch(np, mc).items()}
    for impl in ("auto", "pallas", "float64") + (("modes",) if modes else ()):
        f64 = impl == "float64"
        pmc = replace(mc, backbone=replace(mc.backbone,
                                           kernel_impl="pallas" if impl == "pallas" else "auto"))
        if impl == "modes":
            pmc = with_modes(pmc, AXIS_MODES)
        torch.manual_seed(SEED)
        model = build_model(pmc, device=dev)
        if f64:
            model.double()
        state = create_train_state(model, replace(cfg, model=pmc))
        step = make_train_step(model, aux_weight=mc.aux_loss_weight, num_classes=mc.num_classes,
                               compute_dtype=torch.float64 if f64 else torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dattn.deform_attn = da.deform_attn_reference if f64 else route
        try:
            _, met = step(state, batch)
        finally:
            dattn.deform_attn = route
        torch.cuda.synchronize()
        whole[impl] = {
            "loss": met["loss"].item(),
            "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2 ** 30,
            "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "adamw_bytes": sum(t.numel() * t.element_size()
                               for s in state.optimizer.state.values()
                               for t in s.values() if torch.is_tensor(t) and t.ndim)}
        torch.save({"loss": met["loss"], "inter": met["inter"], "union": met["union"],
                    "grads": {n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None},
                    "params": dict(model.named_parameters()),
                    "stats": {n: b for n, b in model.named_buffers()
                              if n.endswith(("running_mean", "running_var"))}},
                   ref_path(tmp, impl, depths))
        ref_path(tmp, impl, depths).with_suffix(".done").touch()
        plan = model_axis_plan(model, 2)
        whole[impl]["plan_param_share"] = sum(
            p.numel() * p.element_size() / (2 if plan[n].dim is not None else 1)
            for n, p in model.named_parameters()) / whole[impl]["param_bytes"]
        whole[impl]["jax_param_share"] = jax_rule_share(model, 2)
        del model, state, step, met
        torch.cuda.empty_cache()
    torch.manual_seed(SEED)
    model = build_model(mc, device=dev)
    state = create_train_state(model, cfg)
    step = make_train_step(model, aux_weight=mc.aux_loss_weight, num_classes=mc.num_classes,
                           compute_dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, {k: v[:1] for k, v in batch.items()})
    torch.cuda.synchronize()
    whole["auto_one_image"] = {"peak_gib": (torch.cuda.max_memory_allocated() - held) / 2 ** 30}
    del model, state, step
    torch.cuda.empty_cache()
    return whole


def axis_refs_process(rank, tmp, plan):
    """``axis_refs`` at each (depths, modes) of ``plan`` in turn, in a
    process of its own (spawned by ``axis_start``), so that the ranks'
    references are written while the main process works on; the figures
    it returns to ``tmp/whole.pt``."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    whole = {d: axis_refs(torch, np, torch.device("cuda"), tmp, d, modes) for d, modes in plan}
    torch.save(whole, tmp / "whole.pt")


def axis_start(torch, np, tmp):
    """17b-17d, started: the legs of the model_axis, spatial_axis and
    full_mesh phases in one spawn of gloo ranks per world size (two and
    four; a spawn's first leg costs a process start and the kernels' first
    loads) and the one-process references in a process of their own
    (``axis_refs_process``: at ``AXIS_DEPTHS``, then at the preset's depth,
    the ranks waiting for each), all started at once. ``main`` runs the
    export phase's work beside them, up to its times (``axis_wait``).
    Returns the run's state for ``axis_wait`` and ``axis_phases``."""
    from dataclasses import replace

    import torch.multiprocessing as mp

    legs = [mesh_leg(name, "model", shape, depths=AXIS_DEPTHS)
            for shape, names in AXIS_MESHES for name in names]
    legs += [mesh_leg(name, name == "fsdp_ckpt", shape, depths=AXIS_DEPTHS)
             for shape, names in SPATIAL_MESHES for name in names]
    legs += FULL_MESH_LEGS
    by_world = {}
    for leg in legs:
        by_world.setdefault(int(np.prod(list(leg["mesh"].values()))), []).append(leg)
    plan = [(d, any(leg["modes"] and leg["depths"] == d for leg in legs))
            for d in sorted({leg["depths"] for leg in legs}, key=lambda d: d is None)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = {"refs": mp.start_processes(axis_refs_process, args=(str(tmp), plan), nprocs=1,
                                        start_method="spawn", join=False)}
    for world, group in sorted(by_world.items()):
        procs[f"w{world}"] = mp.start_processes(mesh_rank, args=(world, str(tmp), f"w{world}", group),
                                                nprocs=world, start_method="spawn", join=False)
    cut = replace(scale_cfg().model.backbone, depths=AXIS_DEPTHS)
    run = {"tmp": tmp, "by_world": by_world, "procs": procs, "t0": t0, "done_s": None,
           "cut_d": sum(spec[:n].count("D") for spec, n in zip(cut.stage_spec, cut.depths)),
           "used_gib_max": 0.0, "ended_s": None, "stop": threading.Event()}

    def sample():  # the card's memory in use by every process, and when they end
        while not run["stop"].wait(0.5):
            free, total = torch.cuda.mem_get_info()
            run["used_gib_max"] = max(run["used_gib_max"], (total - free) / 2 ** 30)
            if run["ended_s"] is None and not any(p.is_alive() for ctx in procs.values()
                                                  for p in ctx.processes):
                run["ended_s"] = time.perf_counter() - t0

    run["sampler"] = threading.Thread(target=sample, daemon=True)
    run["sampler"].start()
    return run


def axis_kill(run) -> None:
    """Kill every process of ``axis_start``'s run that still runs."""
    run["stop"].set()
    for ctx in run["procs"].values():
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def axis_wait(run, limit=600) -> None:
    """Wait for every process of ``axis_start``'s run (killed, and a
    ``TimeoutError``, ``limit`` s after the start); at once if done."""
    if run["done_s"] is not None:
        return
    end = run["t0"] + limit
    try:
        for name, ctx in run["procs"].items():
            while not ctx.join(timeout=5):
                if time.perf_counter() > end:
                    raise TimeoutError(f"{name}: still running {limit} s after the start")
    except BaseException:
        axis_kill(run)
        raise
    run["done_s"] = time.perf_counter() - run["t0"]
    run["stop"].set()
    run["sampler"].join()


def axis_phases(torch, card, run, n_d, n_x):
    """17b-17d: once ``axis_start``'s processes are done, each phase's lines
    and gates (``n_d``, ``n_x``: K1 and K3 launches a step at the preset's
    depth). Returns rank 0's launches of each phase."""
    axis_wait(run)
    tmp = run["tmp"]
    whole = torch.load(tmp / "whole.pt", weights_only=False)
    results = {}
    for world, group in sorted(run["by_world"].items()):
        ranks = [torch.load(tmp / f"w{world}rank{r}.pt", weights_only=False) for r in range(world)]
        results.update({leg["key"]: [r[leg["key"]] for r in ranks] for leg in group})
        emit({"phase": "axis_ranks", "card": card, "ranks": world,
              "legs": [leg["key"] for leg in group],
              "beside": "the export phase, up to its times, and the other spawn",
              "seconds_all_processes": run["ended_s"] or run["done_s"],
              "seconds_to_the_wait": run["done_s"],
              "card_used_gib_max_beside_the_export": run["used_gib_max"],
              "joined_s": [r["joined_at"] - ranks[0]["joined_at"] for r in ranks],
              "leg_s_rank0": {leg["key"]: {k: ranks[0][leg["key"]][k]
                                           for k in ("setup_s", "seconds", "compare_s")}
                              for leg in group}})
    cut_d = run["cut_d"]
    return (model_axis_report(card, whole[AXIS_DEPTHS], results, cut_d, sum(AXIS_DEPTHS)),
            spatial_axis_report(card, whole[AXIS_DEPTHS], results, cut_d, sum(AXIS_DEPTHS)),
            full_mesh_report(card, whole[None], results, n_d, n_x))


def model_axis_report(card, whole, results, n_d, n_x):
    """17b. model_axis (see the module docstring): its legs' lines and gates
    against ``whole`` (``axis_refs``' figures at ``AXIS_DEPTHS``; ``n_d``,
    ``n_x`` its launches a step). Returns rank 0's K1, K2 and K3 launches in
    the {data: 1, model: 2} steps ('pallas' for K3), and under "modes" the
    modes leg's."""
    bb = scale_cfg().model.backbone
    geo = {s["H"]: s for s in stage_geometry(bb, IMG)}
    pixels = len(AXIS_ROWS) * IMG * IMG
    # the modes leg's K1 blocks: the 'D' blocks of its continuous stages
    modes_d = sum(spec[:n].count("D") for spec, n, m in zip(bb.stage_spec, AXIS_DEPTHS, AXIS_MODES)
                  if m == "continuous")
    for shape, impls in AXIS_MESHES:
        tag = mesh_tag(shape)
        for impl in impls:
            rows = results[f"{impl} {tag}"]
            v = [r["vs_one_process"] for r in rows]
            w = whole[impl]
            local_bytes = [r["param_bytes"] + r["adamw_bytes"] for r in rows]
            emit({"phase": "model_axis", "card": card, "mesh": shape, "fsdp": "model",
                  "kernel_impl": "auto" if impl == "modes" else impl, "leg": impl,
                  "modes": AXIS_MODES if impl == "modes" else None, "preset": TRAIN_PRESET,
                  "dtype": "float64" if impl == "float64" else "float32", "tf32": False,
                  "backend": "gloo (ranks on one card)", "global_batch": len(AXIS_ROWS),
                  "depths": AXIS_DEPTHS, "devices": [r["device"] for r in rows],
                  "loss": [x["loss"] for x in v], "loss_one_process": w["loss"],
                  "loss_rel_err": [x["loss_rel_err"] for x in v],
                  "grad_rel_err": [x["grad_f64"][0] if impl == "float64" else x["grad"][0]
                                   for x in v],
                  "grads_beyond_tol": [x["grad"][1] for x in v],
                  "params_rel_err": [x["params_rel_err"] for x in v],
                  "iou_count_abs_diff": [x["iou_count_abs_diff"] for x in v], "pixels": pixels,
                  "launches_per_rank": [r["launches"] for r in rows],
                  "k1_calls_rank0": rows[0]["k1_calls"],
                  "bytes_per_rank": {"param": [r["param_bytes"] for r in rows],
                                     "adamw": [r["adamw_bytes"] for r in rows],
                                     "share_of_whole": [b / (w["param_bytes"] + w["adamw_bytes"])
                                                        for b in local_bytes],
                                     "whole": {"param": w["param_bytes"],
                                               "adamw": w["adamw_bytes"]},
                                     "plan_param_share": w["plan_param_share"],
                                     "jax_rule_share": w["jax_param_share"]},
                  "peak_gib_per_rank": [r["peak_gib"] for r in rows],
                  "peak_gib_one_process": w["peak_gib"],
                  "step_s": [r["seconds"] for r in rows],
                  "states_equal": len({r["state_sha256"] for r in rows}) == 1,
                  "tol": {"loss": TOL_TRAIN_LOSS, "params": TOL_GRAD,
                          "grad": (f"{TOL_AXIS_F64_GRAD} global, {TOL_AXIS_F64_LEAF} a leaf"
                                   if impl == "float64" else
                                   f"reported against {TOL_GRAD} / {TOL_GRAD_PARAM}, not gated "
                                   "in float32 (AXIS_MESHES' note)")},
                  "note": "gloo through the host on one card: parity and memory, not speed"})
            X = shape["data"]
            for r, (row, x) in enumerate(zip(rows, v)):
                what = f"model_axis {tag} {impl} rank {r}"
                check(x["loss_rel_err"] <= TOL_TRAIN_LOSS,
                      f"{what}: loss rel err {x['loss_rel_err']} > {TOL_TRAIN_LOSS}")
                if impl == "float64":  # every gradient, globally and per leaf
                    rel, off = x["grad_f64"]
                    check(rel <= TOL_AXIS_F64_GRAD and not off,
                          f"{what}: float64 grad rel err {rel}, leaves beyond "
                          f"{TOL_AXIS_F64_LEAF}: {off}")
                check(x["params_rel_err"] <= TOL_GRAD,
                      f"{what}: params rel err {x['params_rel_err']} > {TOL_GRAD}")
                check(x["iou_count_abs_diff"] <= 1e-4 * pixels,
                      f"{what}: IoU counts differ by {x['iou_count_abs_diff']}")
                # the plain version in float64; the continuous blocks only with modes
                k1 = {"float64": 0, "modes": modes_d}.get(impl, n_d)
                want = {"deform_attn_fwd": k1, "deform_attn_bwd": k1,
                        "x_block_fwd": n_x if impl == "pallas" else 0}
                check(row["launches"] == want, f"{what}: launches {row['launches']}, want {want}")
                # each K1 call on this rank's rows and, where the stage splits, half its groups
                groups = [(len(AXIS_ROWS) // X * geo[h]["g"] // (2 if geo[h]["g"] % 2 == 0 else 1),
                           h) for _, h in row["k1_calls"]]
                check(row["k1_calls"] == groups
                      and len(groups) == (modes_d if impl == "modes" else n_d),
                      f"{what}: K1 calls (B·g, H) {row['k1_calls']}, want {groups}")
                share = (row["param_bytes"] + row["adamw_bytes"]) / (
                    w["param_bytes"] + w["adamw_bytes"])
                check(share <= AXIS_MAX_SHARE, f"{what}: bytes share {share} > {AXIS_MAX_SHARE}")
                check(share <= w["jax_param_share"] + JAX_SHARE_SLACK,
                      f"{what}: bytes share {share} > the JAX rule's "
                      f"{w['jax_param_share']} + {JAX_SHARE_SLACK}")
            check(len({r["state_sha256"] for r in rows}) == 1,
                  f"model_axis {tag} {impl}: the ranks' gathered states differ")
    tag = mesh_tag(AXIS_MESHES[0][0])
    return {"deform_attn_fwd": results[f"auto {tag}"][0]["launches"]["deform_attn_fwd"],
            "deform_attn_bwd": results[f"auto {tag}"][0]["launches"]["deform_attn_bwd"],
            "x_block_fwd": results[f"pallas {tag}"][0]["launches"]["x_block_fwd"],
            "modes": results[f"modes {tag}"][0]["launches"]}


# ---- 17c. spatial_axis: each image's rows over the mesh's spatial axis -------
# The flagship's float32 step on axis_batch (the same one-process references
# as model_axis, whose note on float32 gradients holds here too: the halo
# convs and the row-wise resizes sum in other orders) with its rows split
# over spatial peers. {data: 1, spatial: 2} runs the attention on one whole
# image a peer (the rows <-> batch all-to-all); {data: 2, spatial: 2} has one
# image a data coordinate, which S = 2 does not divide, so each peer gathers
# the image's rows for the attention. "fsdp_ckpt": fsdp=True (FSDP2 over the
# data group of one) with use_checkpoint, the 'auto' kernels: twice the K1
# launches (each stage again in the backward).
SPATIAL_MESHES = (({"data": 1, "spatial": 2}, ("auto", "pallas", "float64", "fsdp_ckpt")),
                  ({"data": 2, "spatial": 2}, ("auto",)))


def spatial_axis_report(card, whole, results, n_d, n_x):
    """17c. spatial_axis (see the module docstring): its legs' lines and
    gates, as ``model_axis_report``. Returns rank 0's K1, K2 and K3 launches
    in the {data: 1, spatial: 2} steps ('pallas' for K3)."""
    geo = {s["H"]: s for s in stage_geometry(scale_cfg().model.backbone, IMG)}
    pixels = len(AXIS_ROWS) * IMG * IMG
    want_k1 = {"auto": n_d, "pallas": n_d, "float64": 0, "fsdp_ckpt": 2 * n_d}
    for shape, legs in SPATIAL_MESHES:
        tag = mesh_tag(shape)
        X, S = shape["data"], shape["spatial"]
        for leg in legs:
            rows = results[f"{leg} {tag}"]
            v = [r["vs_one_process"] for r in rows]
            w = whole["float64" if leg == "float64" else "pallas" if leg == "pallas" else "auto"]
            emit({"phase": "spatial_axis", "card": card, "mesh": shape, "leg": leg,
                  "fsdp": leg == "fsdp_ckpt", "use_checkpoint": leg == "fsdp_ckpt",
                  "preset": TRAIN_PRESET, "image": [IMG, IMG],
                  "dtype": "float64" if leg == "float64" else "float32", "tf32": False,
                  "backend": "gloo (ranks on one card)", "global_batch": len(AXIS_ROWS),
                  "attention_route": ("rows <-> batch all-to-all" if len(AXIS_ROWS) // X % S == 0
                                      else "every row gathered"),
                  "depths": AXIS_DEPTHS, "devices": [r["device"] for r in rows],
                  "loss": [x["loss"] for x in v], "loss_one_process": w["loss"],
                  "loss_rel_err": [x["loss_rel_err"] for x in v],
                  "grad_rel_err": [None if x["grad"] is None else
                                   x["grad_f64"][0] if leg == "float64" else x["grad"][0]
                                   for x in v],
                  "params_rel_err": [x["params_rel_err"] for x in v],
                  "iou_count_abs_diff": [x["iou_count_abs_diff"] for x in v], "pixels": pixels,
                  "launches_per_rank": [r["launches"] for r in rows],
                  "k1_calls_rank0": rows[0]["k1_calls"],
                  "halo_rows_per_fetch_rank0": rows[0]["halo_rows_per_fetch"],
                  "exchanges_rank0": rows[0]["exchanges"],
                  "peak_gib_per_rank": [r["peak_gib"] for r in rows],
                  "peak_gib_one_process": w["peak_gib"],
                  "peak_share_of_one_process": [r["peak_gib"] / w["peak_gib"] for r in rows],
                  "peak_gib_one_process_one_image": whole["auto_one_image"]["peak_gib"],
                  "step_s": [r["seconds"] for r in rows],
                  "states_equal": len({r["state_sha256"] for r in rows}) == 1,
                  "tol": {"loss": TOL_TRAIN_LOSS, "params": TOL_GRAD,
                          "grad": (f"{TOL_AXIS_F64_GRAD} global, {TOL_AXIS_F64_LEAF} a leaf"
                                   if leg == "float64" else "reported, not gated in float32 "
                                   "(SPATIAL_MESHES' note)")},
                  "note": "gloo through the host on one card: parity and memory, not speed"})
            for r, (row, x) in enumerate(zip(rows, v)):
                what = f"spatial_axis {tag} {leg} rank {r}"
                check(x["loss_rel_err"] <= TOL_TRAIN_LOSS,
                      f"{what}: loss rel err {x['loss_rel_err']} > {TOL_TRAIN_LOSS}")
                if leg == "float64":  # every gradient, globally and per leaf
                    rel, off = x["grad_f64"]
                    check(rel <= TOL_AXIS_F64_GRAD and not off,
                          f"{what}: float64 grad rel err {rel}, leaves beyond "
                          f"{TOL_AXIS_F64_LEAF}: {off}")
                check(x["params_rel_err"] <= TOL_GRAD,
                      f"{what}: params rel err {x['params_rel_err']} > {TOL_GRAD}")
                check(x["iou_count_abs_diff"] <= 1e-4 * pixels,
                      f"{what}: IoU counts differ by {x['iou_count_abs_diff']}")
                want = {"deform_attn_fwd": want_k1[leg],
                        "deform_attn_bwd": 0 if leg == "float64" else n_d,
                        "x_block_fwd": n_x if leg == "pallas" else 0}
                check(row["launches"] == want, f"{what}: launches {row['launches']}, want {want}")
                # each K1 call on whole maps of one image (its data coordinate's
                # one image gathered, or one of its two by the all-to-all)
                whole_maps = [(geo[h]["g"], h) for _, h in row["k1_calls"]]
                check(row["k1_calls"] == whole_maps
                      and len(whole_maps) == (2 * n_d if leg == "fsdp_ckpt" else n_d),
                      f"{what}: K1 calls (B·g, H) {row['k1_calls']}, want {whole_maps}")
            check(len({r["state_sha256"] for r in rows}) == 1,
                  f"spatial_axis {tag} {leg}: the ranks' states differ")
    tag = mesh_tag(SPATIAL_MESHES[0][0])
    return {"deform_attn_fwd": results[f"auto {tag}"][0]["launches"]["deform_attn_fwd"],
            "deform_attn_bwd": results[f"auto {tag}"][0]["launches"]["deform_attn_bwd"],
            "x_block_fwd": results[f"pallas {tag}"][0]["launches"]["x_block_fwd"]}


# ---- 17d. full_mesh: the model and spatial axes together ---------------------
# The flagship's float32 step on axis_batch with both axes above 1, against
# the same one-process references (the model axis's note on float32
# gradients holds: they are reported, and gated in float64). Each leg is
# (kernel_impl, fsdp, use_checkpoint): fsdp='model' splits the model over
# the model peers on each spatial peer's rows; "fsdp_spatial" shards the
# parameters and AdamW's moments over the spatial peers (HSDP with a data
# group of one), whose shards are held against the same rows of the
# one-process tensors (gathering them, a DTensor redistribute, crashes in
# gloo's CUDA path: scale_out's note). Each K1 launch of the 'auto' leg is
# held against the plain version on its own inputs, K2 at each launch's
# shapes on drawn inputs: on this step's activations a stage-2 call is
# ill-conditioned (its exact dq, dk and dtable nearly vanish, and the float32
# plain version's are float32 noise, far from its float64 version's), so a
# float32 K2 there matches neither.
FULL_MESH = {"data": 1, "model": 2, "spatial": 2}
FULL_MESH_LEGS = [mesh_leg("auto", "model", FULL_MESH, check=True),
                  mesh_leg("pallas", "model", FULL_MESH, check=True),
                  mesh_leg("float64", "model", FULL_MESH), mesh_leg("ckpt", "model", FULL_MESH),
                  mesh_leg("fsdp_spatial", "spatial", FULL_MESH)]


def full_mesh_report(card, whole, results, n_d, n_x):
    """17d. full_mesh (see the module docstring): its legs' lines and gates
    against ``whole`` (``axis_refs``' figures at the preset's depth).
    Returns rank 0's K1, K2 and K3 launches ('pallas' for K3)."""
    geo = {s["H"]: s for s in stage_geometry(scale_cfg().model.backbone, IMG)}
    X, Y, S = (FULL_MESH[a] for a in ("data", "model", "spatial"))
    pixels = len(AXIS_ROWS) * IMG * IMG
    want_k1 = {"auto": n_d, "pallas": n_d, "float64": 0, "ckpt": 2 * n_d, "fsdp_spatial": n_d}
    for spec in FULL_MESH_LEGS:
        leg, impl, fsdp, ckpt = spec["name"], spec["impl"], spec["fsdp"], spec["ckpt"]
        rows = results[spec["key"]]
        v = [r["vs_one_process"] for r in rows]
        w = whole["float64" if leg == "float64" else impl]
        local_bytes = [r["param_bytes"] + r["adamw_bytes"] for r in rows]
        emit({"phase": "full_mesh", "card": card, "mesh": FULL_MESH, "leg": leg, "fsdp": fsdp,
              "kernel_impl": impl, "use_checkpoint": ckpt, "preset": TRAIN_PRESET,
              "image": [IMG, IMG], "dtype": "float64" if leg == "float64" else "float32",
              "tf32": False, "backend": "gloo (ranks on one card)",
              "global_batch": len(AXIS_ROWS), "devices": [r["device"] for r in rows],
              "coords": [r["coords"] for r in rows],
              "loss": [x["loss"] for x in v], "loss_one_process": w["loss"],
              "loss_rel_err": [x["loss_rel_err"] for x in v],
              "grad_rel_err": [x["grad_f64"][0] if leg == "float64" else x["grad"][0]
                               for x in v],
              "params_rel_err": [x["params_rel_err"] for x in v],
              "bn_max_abs_err": [x["bn_max_abs_err"] for x in v],
              "iou_count_abs_diff": [x["iou_count_abs_diff"] for x in v], "pixels": pixels,
              "launches_per_rank": [r["launches"] for r in rows],
              "k1_calls_rank0": rows[0]["k1_calls"],
              "kernel_vs_plain_max_rel_err": [r["kernel_vs_plain"] for r in rows],
              "halo_rows_per_fetch_rank0": rows[0]["halo_rows_per_fetch"],
              "exchanges_rank0": rows[0]["exchanges"],
              "bytes_per_rank": {"param": [r["param_bytes"] for r in rows],
                                 "adamw": [r["adamw_bytes"] for r in rows],
                                 "share_of_whole": [b / (w["param_bytes"] + w["adamw_bytes"])
                                                    for b in local_bytes],
                                 "jax_rule_share": w["jax_param_share"]},
              "peak_gib_per_rank": [r["peak_gib"] for r in rows],
              "peak_gib_one_process": w["peak_gib"],
              "peak_share_of_one_process": [r["peak_gib"] / w["peak_gib"] for r in rows],
              "step_s": [r["seconds"] for r in rows],
              "states_equal": len({r["state_sha256"] for r in rows}) == 1,
              "shards_equal_per_spatial_coordinate": all(
                  len({rows[r]["state_sha256"] for r in range(len(rows)) if r % S == s}) == 1
                  for s in range(S)),
              "tol": {"loss": TOL_TRAIN_LOSS, "params": TOL_GRAD, "bn": TOL_BN,
                      "kernel_vs_plain": {"K1": TOL_F32, "K2": TOL_BWD_F32, "K3": TOL_XB_F32},
                      "grad": (f"{TOL_AXIS_F64_GRAD} global, {TOL_AXIS_F64_LEAF} a leaf"
                               if leg == "float64" else "reported, not gated in float32 "
                               "(AXIS_MESHES' note)")},
              "note": "gloo through the host on one card: parity and memory, not speed"})
        for r, (row, x) in enumerate(zip(rows, v)):
            what = f"full_mesh {leg} rank {r}"
            check(row["coords"] == ((r // S) // Y, (r // S) % Y, r % S),
                  f"{what}: coordinates {row['coords']}, the JAX make_mesh order gives "
                  f"{((r // S) // Y, (r // S) % Y, r % S)}")
            check(x["loss_rel_err"] <= TOL_TRAIN_LOSS,
                  f"{what}: loss rel err {x['loss_rel_err']} > {TOL_TRAIN_LOSS}")
            if leg == "float64":  # every gradient, globally and per leaf
                rel, off = x["grad_f64"]
                check(rel <= TOL_AXIS_F64_GRAD and not off,
                      f"{what}: float64 grad rel err {rel}, leaves beyond "
                      f"{TOL_AXIS_F64_LEAF}: {off}")
            check(x["params_rel_err"] <= TOL_GRAD,
                  f"{what}: params rel err {x['params_rel_err']} > {TOL_GRAD}")
            check(x["bn_max_abs_err"] <= TOL_BN,
                  f"{what}: BN statistics differ by {x['bn_max_abs_err']} > {TOL_BN}")
            check(x["iou_count_abs_diff"] <= 1e-4 * pixels,
                  f"{what}: IoU counts differ by {x['iou_count_abs_diff']}")
            want = {"deform_attn_fwd": want_k1[leg],
                    "deform_attn_bwd": 0 if leg == "float64" else n_d,
                    "x_block_fwd": n_x if leg == "pallas" else 0}
            check(row["launches"] == want, f"{what}: launches {row['launches']}, want {want}")
            # the main path's launches against the plain version on their inputs
            tols = {"auto": {"deform_attn_fwd": TOL_F32, "deform_attn_bwd": TOL_BWD_F32},
                    "pallas": {"x_block_fwd": TOL_XB_F32}}.get(leg, {})
            for kernel, tol in tols.items():
                err = row["kernel_vs_plain"].get(kernel)
                check(err is not None and err <= tol,
                      f"{what}: {kernel} against its plain version {err} > {tol}")
            # each K1 call on whole maps of the rank's B/S images and, under the
            # model axis, half the groups of a stage whose groups divide by 2
            split = fsdp == "model"
            groups = [(len(AXIS_ROWS) // X // S * geo[h]["g"]
                       // (Y if split and geo[h]["g"] % Y == 0 else 1), h)
                      for _, h in row["k1_calls"]]
            check(row["k1_calls"] == groups and len(groups) == (2 if ckpt else 1) * n_d,
                  f"{what}: K1 calls (B·g, H) {row['k1_calls']}, want {groups}")
            share = local_bytes[r] / (w["param_bytes"] + w["adamw_bytes"])
            check(share <= AXIS_MAX_SHARE, f"{what}: bytes share {share} > {AXIS_MAX_SHARE}")
            if fsdp == "model":
                check(share <= w["jax_param_share"] + JAX_SHARE_SLACK,
                      f"{what}: bytes share {share} > the JAX rule's "
                      f"{w['jax_param_share']} + {JAX_SHARE_SLACK}")
        if fsdp == "spatial":  # shards: the model peers of a spatial coordinate agree
            check(all(len({rows[r]["state_sha256"] for r in range(len(rows)) if r % S == s}) == 1
                      for s in range(S)),
                  f"full_mesh {leg}: the model peers of a spatial coordinate hold other shards")
        else:
            check(len({r["state_sha256"] for r in rows}) == 1,
                  f"full_mesh {leg}: the ranks' gathered states differ")
    tag = mesh_tag(FULL_MESH)
    return {"deform_attn_fwd": results[f"auto {tag}"][0]["launches"]["deform_attn_fwd"],
            "deform_attn_bwd": results[f"auto {tag}"][0]["launches"]["deform_attn_bwd"],
            "x_block_fwd": results[f"pallas {tag}"][0]["launches"]["x_block_fwd"]}


# ---- 18. pe_modes: the other position-bias modes (models/deformable_attention.py)
# Each mode on all four stages of the flagship, card vs CPU; then a mixed
# model (dwc_pe on stages 0-1, the continuous bias, K1's, on stages 2-3)
# served and trained. The JAX gate sends only the continuous bias (offsets
# on, attention dropout 0 or eval) to the kernel.
PE_MODES = ("dwc_pe", "fixed_pe", "log_cpb", "no_off", "no_pe")
PE_MIXED = ("dwc_pe", "dwc_pe", "continuous", "continuous")
PE_ATTN_DROP = 0.1
PE_BATCHES = (TRAIN_BATCH, 8, 4, 2)  # a step's batch: the largest of these that fits
PE_TIME_ITERS = 3
_PE_FLAGS = {"dwc_pe": "dwc_pes", "fixed_pe": "fixed_pes", "log_cpb": "log_cpb",
             "no_off": "no_offs"}


def with_modes(model_cfg, modes, **backbone):
    """``model_cfg`` with stage i's 'D' blocks in the position-bias mode
    ``modes[i]`` ('continuous', a key of ``_PE_FLAGS`` or 'no_pe') and the
    backbone's other fields ``backbone``."""
    from dataclasses import replace

    kw = {field: tuple(m == mode for m in modes) for mode, field in _PE_FLAGS.items()}
    kw["use_pes"] = tuple(m != "no_pe" for m in modes)
    return replace(model_cfg, backbone=replace(model_cfg.backbone, **kw, **backbone))


def pe_modes_phase(torch, np, card, dev, timed):
    """18. pe_modes (see the module docstring). Returns K1's and K2's
    launches on the mixed model's serve (one forward) and its train step
    with attention dropout 0 (one step), counts set to 0 just before each."""
    from dataclasses import replace

    from dat_segmentation_tpu_torch import (SegInferencer, build_model, create_train_state,
                                            get_config, make_train_step)
    from dat_segmentation_tpu_torch.models.deformable_attention import DeformableAttention
    from dat_segmentation_tpu_torch.ops import deform_attn as da

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(PRESET).model
    spec = cfg.backbone.stage_spec
    k1_blocks = sum(spec[i].count("D") for i, m in enumerate(PE_MIXED) if m == "continuous")
    composite_blocks = sum(s.count("D") for s in spec) - k1_blocks
    composite_calls = [0]
    real_composite = DeformableAttention._composite

    def counted(self, *a, **k):  # the composite's blocks, counted as K1's launches are
        composite_calls[0] += 1
        return real_composite(self, *a, **k)

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2 ** 30

    # -- each mode on every stage, float32, TF32 off: card vs CPU --------------
    image = torch.tensor(np.random.RandomState(SEED + 30).randn(1, IMG, IMG, 3),
                         dtype=torch.float32)
    for mode in PE_MODES:
        torch.manual_seed(SEED)
        model = build_model(with_modes(cfg, (mode,) * 4), device=dev)
        da.deform_attn.launches = 0
        with torch.inference_mode():
            got = model(image.to(dev)).float()
            torch.cuda.synchronize()
            launches = da.deform_attn.launches
            t0 = time.perf_counter()
            ref = copy.deepcopy(model).cpu()(image)
            cpu_s = time.perf_counter() - t0
        d = (got.cpu() - ref).abs().max().item()
        emit({"phase": "pe_modes", "card": card, "part": "card vs CPU", "preset": PRESET,
              "mode": mode, "stages": "all four", "dtype": "float32", "tf32": False,
              "input": list(image.shape), "max_abs_dlogit": d, "tol": TOL_MODEL,
              "logit_absmax": ref.abs().max().item(),
              "argmax_agreement": (got.cpu().argmax(-1) == ref.argmax(-1)).float().mean().item(),
              "deform_attn_fwd_launches": launches, "cpu_forward_s": cpu_s})
        check(d <= TOL_MODEL and bool(torch.isfinite(got).all()),
              f"pe_modes {mode}: card vs CPU max |dlogit| {d} > {TOL_MODEL}")
        check(launches == 0, f"pe_modes {mode}: {launches} K1 launches, want 0 (the JAX gate)")
        del model, got, ref
    torch.cuda.empty_cache()

    # -- the mixed model served in bf16 at batch 16, in turns with the flagship --
    torch.manual_seed(SEED)
    servers = {"flagship": SegInferencer(build_model(cfg, device=dev), num_classes=cfg.num_classes,
                                         device=dev)}
    torch.manual_seed(SEED)
    servers["mixed"] = SegInferencer(build_model(with_modes(cfg, PE_MIXED), device=dev),
                                     num_classes=cfg.num_classes, device=dev)
    x16 = torch.tensor(np.random.RandomState(SEED + 31).randn(TIME_BATCH, IMG, IMG, 3),
                       dtype=torch.bfloat16, device=dev)
    DeformableAttention._composite = counted
    try:
        torch.cuda.synchronize()
        da.deform_attn.launches = composite_calls[0] = 0
        out = servers["mixed"].forward_batch(x16)
        torch.cuda.synchronize()
        serve = {"deform_attn_fwd": da.deform_attn.launches, "composite": composite_calls[0]}
    finally:
        DeformableAttention._composite = real_composite
    check(serve == {"deform_attn_fwd": k1_blocks, "composite": composite_blocks},
          f"pe_modes mixed serve: {serve}, want {k1_blocks} K1 and {composite_blocks} composite")
    check(bool(torch.isfinite(out).all()), "pe_modes mixed serve: non-finite logits")
    ms = {"flagship": [], "mixed": []}
    for name in ("flagship", "mixed", "mixed", "flagship"):
        ms[name].append(timed(lambda: servers[name].forward_batch(x16), 5))
    peak = {name: peak_of(lambda: srv.forward_batch(x16)) for name, srv in servers.items()}
    emit({"phase": "pe_modes", "part": "serve", "card": card, "preset": PRESET,
          "modes_by_stage": PE_MIXED, "dtype": "bfloat16", "batch": TIME_BATCH,
          "launches_per_forward": serve, "order": "flagship mixed mixed flagship",
          "ms_per_batch": ms, "img_per_s": {k: [TIME_BATCH / v * 1e3 for v in vs]
                                            for k, vs in ms.items()},
          "peak_mem_gib": peak})
    del servers, out
    torch.cuda.empty_cache()

    # -- train steps of the UperNet preset with the mixed backbone, bf16 -------
    tcfg = get_config(TRAIN_PRESET)
    mc = tcfg.model
    rng = np.random.RandomState(SEED + 32)
    label = rng.randint(0, mc.num_classes, (TRAIN_BATCH, IMG, IMG))
    label[rng.rand(TRAIN_BATCH, IMG, IMG) < 0.05] = 255
    b16 = {"image": torch.tensor(rng.randn(TRAIN_BATCH, IMG, IMG, 3), dtype=torch.float32,
                                 device=dev),
           "label": torch.tensor(label, dtype=torch.long, device=dev)}

    def trainer(model_cfg):
        torch.manual_seed(SEED)
        model = build_model(model_cfg, device=dev)
        state = create_train_state(model, replace(
            tcfg, model=model_cfg, schedule=replace(tcfg.schedule, warmup_iters=0)))
        step = make_train_step(model, aux_weight=mc.aux_loss_weight,
                               num_classes=mc.num_classes, compute_dtype=torch.bfloat16)
        return model, state, step

    runs = {}
    for name, drop, ckpt in (("attn_drop 0", 0.0, False), ("attn_drop 0.1", PE_ATTN_DROP, False),
                             ("attn_drop 0.1, use_checkpoint", PE_ATTN_DROP, True)):
        model, state, step = trainer(with_modes(mc, PE_MIXED, attn_drop_rate=drop,
                                                use_checkpoint=ckpt))
        torch.cuda.synchronize()
        da.deform_attn.launches = da.deform_attn_bwd.launches = 0
        first = step(state, b16)[1]
        torch.cuda.synchronize()
        launches = {"deform_attn_fwd": da.deform_attn.launches,
                    "deform_attn_bwd": da.deform_attn_bwd.launches}
        second = step(state, b16)[1]
        runs[name] = {"losses": [first["loss"].item(), second["loss"].item()],
                      "grad_norms": [first["grad_norm"].item(), second["grad_norm"].item()],
                      "launches_step1": launches}
        del model, state, step, first, second
        torch.cuda.empty_cache()
    want_k1 = {"attn_drop 0": k1_blocks, "attn_drop 0.1": 0,
               "attn_drop 0.1, use_checkpoint": 0}
    plain, ck = runs["attn_drop 0.1"], runs["attn_drop 0.1, use_checkpoint"]
    loss_rel = abs(ck["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
    gn_rel = abs(ck["grad_norms"][0] - plain["grad_norms"][0]) / plain["grad_norms"][0]
    emit({"phase": "pe_modes", "part": "train", "card": card, "preset": TRAIN_PRESET,
          "modes_by_stage": PE_MIXED, "dtype": "bfloat16", "batch": TRAIN_BATCH, "runs": runs,
          "use_checkpoint_vs_plain": {"loss_step1_rel": loss_rel, "grad_norm_step1_rel": gn_rel,
                                      "loss_step2_rel": abs(ck["losses"][1] - plain["losses"][1])
                                      / abs(plain["losses"][1])},
          "tol": {"loss": TOL_TRAIN_LOSS, "grad_norm": TOL_GRAD}})
    for name, run in runs.items():
        want = {"deform_attn_fwd": want_k1[name], "deform_attn_bwd": want_k1[name]}
        check(run["launches_step1"] == want,
              f"pe_modes train {name}: launches {run['launches_step1']}, want {want}")
        check(all(np.isfinite(run["losses"] + run["grad_norms"])),
              f"pe_modes train {name}: non-finite {run}")
    check(loss_rel <= TOL_TRAIN_LOSS and gn_rel <= TOL_GRAD,
          f"pe_modes train: use_checkpoint with attention dropout vs plain: loss {loss_rel}, "
          f"grad norm {gn_rel}")

    # -- times: each mode on every stage, bf16, the forward and the step -------
    times = {}
    for mode in ("continuous",) + PE_MODES:
        model, state, step = trainer(with_modes(mc, (mode,) * 4))
        row = {}
        for batch in PE_BATCHES:
            b = {k: v[:batch] for k, v in b16.items()}
            try:
                step(state, b)
                row["step_ms"] = timed(lambda: step(state, b), PE_TIME_ITERS, warmup=1)
                row["step_peak_gib"] = peak_of(lambda: step(state, b))
                row["step_batch"] = batch
                break
            except torch.cuda.OutOfMemoryError:
                row.setdefault("step_out_of_memory_at", []).append(batch)
                torch.cuda.empty_cache()
        check("step_ms" in row, f"pe_modes times {mode}: no step fits at batches {PE_BATCHES}")
        del state, step
        server = SegInferencer(model, num_classes=mc.num_classes, device=dev)
        del model
        torch.cuda.empty_cache()
        row["forward_ms"] = timed(lambda: server.forward_batch(x16), PE_TIME_ITERS, warmup=1)
        row["forward_peak_gib"] = peak_of(lambda: server.forward_batch(x16))
        row["forward_batch"] = TIME_BATCH
        if mode == "dwc_pe":  # where the composite's time goes
            row["forward_profile"] = profile_device(torch, lambda: server.forward_batch(x16), card,
                                                    row["forward_ms"], "forward", iters=2)
        times[mode] = row
        del server
        torch.cuda.empty_cache()
    emit({"phase": "pe_modes", "part": "times", "card": card, "preset": TRAIN_PRESET,
          "dtype": "bfloat16", "stages": "all four in the mode", "note":
          "continuous: K1 (K2 in the step); the others: the plain composite", "by_mode": times})
    emit({"phase": "pe_modes", "card": card, "seconds": time.perf_counter() - t_phase})
    return {"serve": serve["deform_attn_fwd"], "train": runs["attn_drop 0"]["launches_step1"]}


def grad_compare(gmodel, cmodel):
    """The card's gradients against the CPU's after one step of the same
    model: ||g_card - g_cpu|| / ||g_cpu|| over all parameters, the worst
    parameter whose gradient is not float32 noise (d, ||g||, name), the
    names beyond TOL_GRAD_PARAM, every (d, ||g||, name) and ||g||². A
    parameter the loss does not reach (the classifier's out_norm_0-2) has a
    zero gradient on both sides (the train step gives it one); one side
    without a gradient is a difference."""
    dsq = gsq = 0.0
    per_param = []
    for (name, pg), (_, pc) in zip(gmodel.named_parameters(), cmodel.named_parameters()):
        if pg.grad is None and pc.grad is None:
            continue
        if pg.grad is None or pc.grad is None:
            per_param.append((float("inf"), 0.0, name))
            continue
        d = (pg.grad.cpu() - pc.grad).norm().item()
        gn = pc.grad.norm().item()
        dsq, gsq = dsq + d * d, gsq + gn * gn
        per_param.append((d, gn, name))
    worst = max((t for t in per_param if t[1] > 1e-6 * gsq ** 0.5), key=lambda t: t[0] / t[1])
    off = [n for d, g, n in per_param if d > TOL_GRAD_PARAM * g + 1e-6 * gsq ** 0.5]
    return (dsq / gsq) ** 0.5, worst, off, per_param, gsq


def stage_geometry(bb, img):
    """K1's shapes at each stage of backbone ``bb`` on an img x img input:
    groups, heads a group, channels a group, the query grid, the samples
    (the offset conv's output grid), the table side, launches a forward."""
    stages = []
    for i in range(4):
        H = img // bb.patch_size // 2 ** i
        ks, st = bb.ksizes[i], bb.strides[i]
        Hk = (H + 2 * (ks // 2 if ks != st else 0) - ks) // st + 1  # the offset conv's output
        q_size = bb.img_size // bb.patch_size // 2 ** i
        stages.append(dict(
            stage=i, g=bb.groups[i], h_g=bb.heads[i] // bb.groups[i],
            Cg=bb.dims[i] // bb.groups[i], H=H, W=H, Ns=Hk * Hk,
            th=2 * q_size - 1, launches_per_forward=bb.stage_spec[i].count("D"),
        ))
    return stages


def k3_gate_count(bb, h, w):
    """K3 launches of one backbone forward of an h x w input under the JAX
    package's gate (models/dat.py:103-118 there): every block of a stage
    whose sides are multiples of 8, none elsewhere. Stage sizes follow the
    stem and downsamplers: 3x3 stride-2 convs (ceil) with conv patches,
    else the patch conv and 2x2 ones (floor)."""
    def down(v):
        return -(-v // 2) if bb.use_conv_patches else v // 2

    if bb.use_conv_patches:
        h, w = down(down(h)), down(down(w))
    else:
        h, w = h // bb.patch_size, w // bb.patch_size
    n = 0
    for i, depth in enumerate(bb.depths):
        if i:
            h, w = down(h), down(w)
        if h % 8 == 0 and w % 8 == 0:
            n += depth
    return n


def x_block_bound(bb, stages, card, batch=TIME_BATCH, expansion=4):
    """The least time of K3 (``csrc/x_block_fwd.cu``, the port of the TPU
    kernel ``ops/pallas/x_block.py:227`` ``_fwd_pallas``) per forward of the flagship at
    ``batch``, bf16: x read, out written and the weights read once over
    the memory rate; the fc1/fc2 and depthwise products over the bf16
    rate. It runs in 'X' blocks (LPU dw3 + dw7 window) and, in MLP-only
    mode (k = 1), in the second half of each 'D' block. Arithmetic only."""
    rows, tot = [], {"ops_ms": 0.0, "bytes_ms": 0.0, "bound_ms": 0.0}
    for s in stages:
        C, H, W = bb.dims[s["stage"]], s["H"], s["W"]
        E, n = expansion * C, batch * H * W
        for mode, k, lpu, calls in (("X", bb.window_sizes[s["stage"]], True,
                                     bb.stage_spec[s["stage"]].count("X")),
                                    ("mlp", 1, False, s["launches_per_forward"])):
            if not calls:
                continue
            weights = (9 * C + C if lpu else 0) + k * k * C + C + 2 * C + 2 * C * E + E \
                + 9 * E + E + C
            ops = 2.0 * n * 2 * C * E + 2.0 * n * (C * ((9 if lpu else 0) + k * k) + 9 * E)
            nbytes = (2 * n * C + weights) * 2
            ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            bound = max(ops_ms, bytes_ms)
            rows.append({"stage": s["stage"], "mode": mode, "x": [batch, H, W, C], "k": k,
                         "calls_per_forward": calls, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                         "bound_ms": bound,
                         "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
            for key, val in (("ops_ms", ops_ms), ("bytes_ms", bytes_ms), ("bound_ms", bound)):
                tot[key] += val * calls
    return {"phase": "bound", "card": card, "kernel": "x_block_fwd (K3, ported)",
            "replaces": "dat_segmentation_tpu/ops/pallas/x_block.py:227", "dtype": "bfloat16",
            "batch": batch, "per_forward": tot, "rows": rows}


def device_launches(torch, fn):
    """``fn()``'s result and the launches of each of ``KERNEL_NAMES`` that
    ran on the card in it, counted by name on the profiler's device track:
    a forward replayed from a CUDA graph launches its kernels without their
    wrappers, whose ``.launches`` count only their own calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    return out, {k: sum(k in n for n in names) for k in KERNEL_NAMES}


def profile_device(torch, fn, card, ref_ms, unit, iters=3):
    """Device time of a few calls of ``fn`` by kernel name; the busy share
    is that time over ``ref_ms``, one call timed with CUDA events and no
    profiler (the profiler's own host work stretches the wall time it
    sees). ``unit`` names a call ('forward', 'step')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host ops also carry their kernels' device time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / iters, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    if device_ms == 0:
        return {"phase": "profile", "card": card, "unit": unit, "device_time": "not measured"}
    return {"phase": "profile", "card": card, "unit": unit, "dtype": "bfloat16", "iters": iters,
            f"profiled_wall_ms_per_{unit}": wall_ms / iters,
            f"device_ms_per_{unit}": device_ms, f"{unit}_ms": ref_ms,
            "device_busy_share": device_ms / ref_ms,
            "kernels_ms": {name: sum(ms for ms, k in rows if name in k) for name in KERNEL_NAMES},
            "top": [{"kernel": k[:100], f"ms_per_{unit}": ms, "share": ms / device_ms}
                    for ms, k in rows[:12]]}


if __name__ == "__main__":
    sys.exit(main())
