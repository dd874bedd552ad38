"""Rank functions of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_model_axis.py, tests/test_torch_spatial_axis.py,
tests/test_torch_full_mesh.py).

Imports no JAX: ``spawn`` starts one process a rank (``torch.multiprocessing``,
spawn), each joins a gloo group on the CPU through
``parallel.init_distributed`` with a ``file://`` rendezvous under the test's
temporary directory (so that pytest-xdist workers never meet on a port),
runs its tasks and writes what they return to ``rank<r>.pt`` there. Each
task takes the GLOBAL batch and keeps its rank's rows, so the test calls it
once more in its own process, with no group and ``(rank, world) = (0, 1)``,
for the one-process step on the whole batch.

The tiny geometry is the JAX package's ``tests/test_parallel.py``:
depths 1,1,1,1, dims 16-128, 64² images, a global batch of 4, float32.
"""

import dataclasses
import os
import signal
from pathlib import Path

import numpy as np
import torch

LR = 1e-3
NUM_CLASSES = 8


def tiny_seg(get_config, drop=0.1, num_classes=NUM_CLASSES, drop_rate=0.0):
    """upn_tiny_160k_dp03_lr6 cut to the JAX test's tiny UperNet (heads with
    BatchNorm, the FCN aux head), drop path and the heads' dropout at
    ``drop``, the backbone's dropout (MLPs, attention output) at
    ``drop_rate``, from either package's ``get_config``; the TrainConfig
    (lr 1e-3, no warm-up, float32)."""
    cfg = get_config("upn_tiny_160k_dp03_lr6")
    bb = dataclasses.replace(
        cfg.model.backbone, depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), dim_stem=16,
        heads=(2, 2, 4, 4), groups=(1, 2, 2, 4), stage_spec=(("D",), ("D",), ("X",), ("D",)),
        drop_path_rate=drop, drop_rate=drop_rate,
    )
    model = dataclasses.replace(
        cfg.model, backbone=bb, num_classes=num_classes,
        decode_head=dataclasses.replace(
            cfg.model.decode_head, channels=32, num_classes=num_classes,
            kwargs=dict(cfg.model.decode_head.kwargs, dropout_ratio=drop)),
        auxiliary_head=dataclasses.replace(
            cfg.model.auxiliary_head, channels=16, num_classes=num_classes,
            kwargs=dict(cfg.model.auxiliary_head.kwargs, dropout_ratio=drop)),
    )
    return _train(cfg, model)


def tiny_cls(get_config, num_classes=10):
    """cls_tiny_imagenet at the tiny widths, drop path 0.1, clip 5.0."""
    cfg = get_config("cls_tiny_imagenet")
    bb = dataclasses.replace(
        cfg.model.backbone, depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), dim_stem=16,
        heads=(2, 2, 4, 4), groups=(1, 2, 2, 4), stage_spec=(("D",), ("D",), ("X",), ("D",)),
        drop_path_rate=0.1,
    )
    model = dataclasses.replace(
        cfg.model, backbone=bb, num_classes=num_classes,
        decode_head=dataclasses.replace(cfg.model.decode_head, num_classes=num_classes))
    return _train(cfg, model)


def _train(cfg, model):
    return dataclasses.replace(
        cfg, model=model, dtype="float32",
        optimizer=dataclasses.replace(cfg.optimizer, lr=LR),
        schedule=dataclasses.replace(cfg.schedule, warmup_iters=0, max_iters=20),
    )


def seg_batches(steps=2, seed=0):
    """Global batches of 4: rank 1's rows (2 and 3) are 90% ignored."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        label = rng.randint(0, NUM_CLASSES, (4, 64, 64)).astype(np.int32)
        label[2:][rng.rand(2, 64, 64) < 0.9] = 255
        label[0, :5] = 255
        out.append({"image": rng.randn(4, 64, 64, 3).astype(np.float32), "label": label})
    return out


def _rows(a, rank, world):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _numpy(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


# ------------------------------------------------------------------ spawn --


def spawn(tmp, tasks, world=2, device="cpu"):
    """Start ``world`` ranks running ``tasks`` ([(key, function name,
    kwargs)], in turn); returns the context to ``collect``. With
    ``device="cuda"`` every rank runs on the one card (gloo: NCCL refuses
    two ranks on one GPU). The tasks go to the ranks in a file: a process's
    arguments larger than a pipe's buffer would hold ``start`` until the
    child had imported torch, one child after the other."""
    import pickle

    import torch.multiprocessing as mp

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "tasks.pkl").write_bytes(pickle.dumps(tasks))
    return mp.start_processes(_entry, args=(world, str(tmp), device), nprocs=world,
                              start_method="spawn", join=False)


def collect(ctx, tmp, world=2, timeout=300):
    """Wait for the ranks (an error in one is raised here); their results."""
    import time

    end = time.time() + timeout
    while not ctx.join(timeout=max(end - time.time(), 1)):
        if time.time() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(rank, world, tmp, device):
    import pickle

    tasks = pickle.loads((Path(tmp) / "tasks.pkl").read_bytes())
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dat_segmentation_tpu_torch.parallel import destroy_distributed, init_distributed

    init_distributed("gloo", init_method=f"file://{tmp}/rendezvous",
                     device=None if device == "cuda" else device)
    try:
        out = {key: globals()[name](rank, world, **kw) for key, name, kw in tasks}
    finally:
        destroy_distributed()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


# ------------------------------------------------------------------ tasks --


def _model(cfg, weights, device="cpu"):
    from dat_segmentation_tpu_torch import build_model

    torch.manual_seed(0)
    model = build_model(cfg.model, device=device)
    if weights is not None:
        model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def whole_grads(model):
    """The gradients of ``model`` by name, a split model's gathered whole
    (``p.grad`` of an unsplit model as it is)."""
    from dat_segmentation_tpu_torch.parallel import mesh

    axis = mesh.model_axis_of(model)
    dims = getattr(model, "model_axis_dims", {})
    return {n: (mesh.gather_tensor(p.grad, dims[n], axis) if n in dims else p.grad)
            for n, p in model.named_parameters() if p.grad is not None}


def local_shapes(model, state):
    """Per split leaf (parameters and buffers) its local shape, and per
    parameter its AdamW moment's."""
    return {"leaves": {n: tuple(t.shape) for n, t in model.state_dict().items()},
            "moments": {n: tuple(state.optimizer.state[p]["exp_avg"].shape)
                        for n, p in model.named_parameters() if p in state.optimizer.state}}


def seg_steps(rank, world, *, weights=None, batches, drop=0.1, fsdp=False, kernel_impl="auto",
              use_checkpoint=False, model_cfg=None, device="cpu", mesh_shape=None, drop_rate=0.0,
              groups=False, round_trip=False):
    """Steps of the tiny UperNet (or ``model_cfg``) from ``weights`` on this
    data coordinate's rows of each global batch on the mesh ``mesh_shape``,
    on ``device``, with ``use_checkpoint`` as given: per step the metrics,
    the K1/K2 launches, the whole state (parameters and BN buffers,
    gathered when sharded or split) and, unless FSDP shards them, the
    gradients (gathered when split); with ``fsdp=True`` also the local
    shape of the largest parameter and of its AdamW moment, with
    ``fsdp='model'`` every leaf's and moment's local shape; and whether
    K3's weights came whole and contiguous; with ``groups``, (B·g, H) of
    each deformable-attention call of the first step; with ``round_trip``,
    the AdamW moments after the steps in the one-process format
    (``full_state``) by parameter name, and whether a fresh model and
    optimizer made as these were and given that state
    (``load_full_state``) hold this rank's parameters and moments bit for
    bit."""
    from dat_segmentation_tpu_torch import create_train_state, get_config, make_train_step
    from dat_segmentation_tpu_torch.configs.schema import replace
    from dat_segmentation_tpu_torch.models import deformable_attention as dattn
    from dat_segmentation_tpu_torch.ops import deform_attn as da
    from dat_segmentation_tpu_torch.ops import x_block
    from dat_segmentation_tpu_torch.parallel import mesh

    cfg = tiny_seg(get_config, drop=drop, drop_rate=drop_rate)
    if model_cfg is not None:
        cfg = dataclasses.replace(cfg, model=model_cfg)
    cfg = replace(cfg, fsdp=fsdp, **{"model.backbone.kernel_impl": kernel_impl,
                                     "model.backbone.use_checkpoint": use_checkpoint})
    if mesh_shape is not None:
        cfg = dataclasses.replace(cfg, mesh_shape=mesh_shape)
    model = _model(cfg, weights, device)
    state = create_train_state(model, cfg)
    rank, world = mesh.process_shard_info()
    step = make_train_step(model, num_classes=NUM_CLASSES, compute_dtype=torch.float32)
    seen = []
    real = x_block.x_block_reference

    def watched(x, *params, **kw):  # K3's plain version, as the CPU runs it
        seen.append(all(p is None or (p.is_contiguous() and not hasattr(p, "to_local"))
                        for p in params))
        return real(x, *params, **kw)

    x_block.x_block_reference = watched
    calls = []
    real_attn = dattn.deform_attn

    def attn(q, *a, **k):  # the module's K1 route, seen from outside
        calls.append((q.shape[0], q.shape[1]))
        return real_attn(q, *a, **k)

    if groups:
        dattn.deform_attn = attn
    out = []
    try:
        for b in batches:
            before = (da.deform_attn.launches, da.deform_attn_bwd.launches,
                      x_block.x_block_fwd.launches)
            _, m = step(state, {k: _rows(v, rank, world) for k, v in b.items()})
            grads = {} if mesh.is_sharded(model) else whole_grads(model)
            out.append({"metrics": _numpy(m), "state": _numpy(mesh.full_state(
                model, everywhere=True)[0]), "grads": _numpy(grads),
                "launches": (da.deform_attn.launches - before[0],
                             da.deform_attn_bwd.launches - before[1]),
                "k3_launches": x_block.x_block_fwd.launches - before[2]})
    finally:
        x_block.x_block_reference = real
        dattn.deform_attn = real_attn
    res = {"steps": out, "k3_whole_contiguous": seen}
    if groups:
        res["groups"] = calls[:len(calls) // len(batches)]
    if round_trip:
        res.update(_round_trip(model, state, cfg, weights, device))
    if fsdp == "model":
        res["local"] = local_shapes(model, state)
    elif fsdp:
        name, p = max(model.named_parameters(), key=lambda kv: kv[1].numel())
        moment = state.optimizer.state[p]["exp_avg"]
        res["sharded"] = {"name": name, "shape": tuple(p.shape),
                          "local": tuple(mesh.local(p).shape),
                          "moment_local": tuple(mesh.local(moment).shape)}
    return res


def _round_trip(model, state, cfg, weights, device):
    from dat_segmentation_tpu_torch import create_train_state
    from dat_segmentation_tpu_torch.parallel import mesh

    names = mesh._param_names(model, state.optimizer)
    msd, osd = mesh.full_state(model, state.optimizer, everywhere=True)
    moments = {names[i]: {k: v.detach().cpu().numpy().copy() for k, v in s.items()
                          if k in ("exp_avg", "exp_avg_sq")} for i, s in osd["state"].items()}
    fresh = _model(cfg, weights, device)
    again = create_train_state(fresh, cfg)
    mesh.load_full_state(fresh, msd, again.optimizer, osd)
    held = dict(model.named_parameters())
    same = all(torch.equal(p, held[n]) for n, p in fresh.named_parameters())
    for p, q in zip(fresh.parameters(), model.parameters()):
        a, b = again.optimizer.state[p], state.optimizer.state[q]
        same = same and all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq"))
    return {"moments": moments, "reloaded_equal": same}


class FixedDraws:
    """A ``MixupSampler`` that hands out given draws in turn."""

    def __init__(self, draws):
        self.draws = list(draws)

    def draw(self, h, w):
        return self.draws.pop(0)


def cls_steps(rank, world, *, weights, batch, draws, valid, mesh_shape=None, fsdp=False):
    """Steps of the tiny classifier with mixup (one step per draw, all on
    ``batch``) on this data coordinate's rows, on the mesh ``mesh_shape``:
    per step the metrics, the whole state and gradients; then the metric
    step's counts on the rows and ``valid``."""
    from dat_segmentation_tpu_torch import create_train_state, get_config, make_train_step
    from dat_segmentation_tpu_torch.parallel import mesh
    from dat_segmentation_tpu_torch.train.train_step import make_cls_metric_step

    cfg = dataclasses.replace(tiny_cls(get_config), fsdp=fsdp)
    if mesh_shape is not None:
        cfg = dataclasses.replace(cfg, mesh_shape=mesh_shape)
    model = _model(cfg, weights)
    state = create_train_state(model, cfg)
    rank, world = mesh.process_shard_info()
    state.mixup = FixedDraws(draws)
    step = make_train_step(model, task="cls", num_classes=cfg.model.num_classes,
                           compute_dtype=torch.float32, mixup=True)
    local = {k: _rows(v, rank, world) for k, v in batch.items()}
    out = []
    for _ in draws:
        _, m = step(state, local)
        out.append({"metrics": _numpy(m),
                    "state": _numpy(mesh.full_state(model, everywhere=True)[0]),
                    "grads": _numpy(whole_grads(model))})
    hits = make_cls_metric_step(model, compute_dtype=torch.float32)(
        local["image"], local["label"], _rows(valid, rank, world))
    return {"steps": out, "hits": hits.numpy()}


def eval_logits(rank, world, *, weights, image, mesh_shape, drop=0.0, fsdp=False):
    """``make_eval_step`` of the tiny UperNet (eval, float32) on this data
    coordinate's rows of ``image`` on the mesh ``mesh_shape`` (with
    ``fsdp='model'`` the model split over the model axis): the global
    batch's logits, as every rank gets them."""
    from dat_segmentation_tpu_torch import get_config
    from dat_segmentation_tpu_torch.parallel import make_eval_step, process_shard_info, resolve_mesh
    from dat_segmentation_tpu_torch.parallel.model_axis import shard_model_axis

    model = _model(tiny_seg(get_config, drop=drop), weights)
    lay = resolve_mesh(mesh_shape, fsdp)
    if fsdp == "model":
        shard_model_axis(model, lay.model_axis)
    rank, world = process_shard_info()
    return make_eval_step(model, compute_dtype=torch.float32)(_rows(image, rank, world)).numpy()


def mesh_coords(rank, world, *, shapes):
    """Per mesh of ``shapes``, this rank's (data, model, spatial)
    coordinates in the layout ``resolve_mesh`` makes, and the sizes of its
    data, model, spatial and rows groups (1 for a group it has none of)."""
    import torch.distributed as dist

    from dat_segmentation_tpu_torch.parallel import resolve_mesh

    out = []
    for shape in shapes:
        lay = resolve_mesh(shape)
        out.append({"coords": (lay.data_rank, lay.model_rank, lay.spatial_rank),
                    "group_sizes": (dist.get_world_size(lay.data_group),
                                    1 if lay.model_group is None else
                                    dist.get_world_size(lay.model_group),
                                    1 if lay.spatial_group is None else
                                    dist.get_world_size(lay.spatial_group),
                                    dist.get_world_size(lay.rows_group))})  # None: the world
    return out


class Head:
    """The first ``n`` items of ``dataset``."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return self.dataset[idx]


def cls_val(rank, world, *, weights, root, items=5, batch_size=2):
    """``trainer_cls.evaluate_topk`` of the tiny classifier over the first
    ``items`` val images of ``root`` at 64², ``batch_size`` a process: the
    global [hits1, hits5, total]."""
    from dat_segmentation_tpu_torch import get_config
    from dat_segmentation_tpu_torch.data.imagenet import ImageNetDataset
    from dat_segmentation_tpu_torch.train.train_step import make_cls_metric_step
    from dat_segmentation_tpu_torch.train.trainer_cls import evaluate_topk

    eval_fn = make_cls_metric_step(_model(tiny_cls(get_config), weights),
                                   compute_dtype=torch.float32)
    return evaluate_topk(eval_fn, Head(ImageNetDataset(str(root), "val", size=64), items),
                         batch_size)


def cls_train(rank, world, *, root, work):
    """``train_classifier`` of the tiny classifier on ``root`` at 64², a
    global batch of 4, one epoch of two steps (mixup, drop path, clip):
    the step reached, the history and the checkpoints written."""
    from dat_segmentation_tpu_torch import get_config
    from dat_segmentation_tpu_torch.configs.schema import replace
    from dat_segmentation_tpu_torch.train.trainer_cls import train_classifier

    cfg = replace(tiny_cls(get_config), work_dir=str(work), name="cls", **{
        "data.data_root": str(root), "data.batch_size": 4, "data.crop_size": (64, 64),
        "data.num_workers": 1, "log_interval": 1})
    state, hist = train_classifier(cfg, epochs=1, device="cpu")
    return {"step": state.step, "history": hist,
            "ckpts": sorted(p.name for p in (Path(work) / "cls").iterdir()
                            if p.name.startswith(("ckpt_", "backbone_")))}


def evaluate(rank, world, *, weights, root, max_images=None):
    """``evaluate_dataset`` of the tiny UperNet on the val split of
    ``root``, this rank's shard, the counts summed over the group."""
    from dat_segmentation_tpu_torch import SegInferencer, get_config
    from dat_segmentation_tpu_torch.data.ade20k import ADE20KDataset
    from dat_segmentation_tpu_torch.eval.evaluate import evaluate_dataset
    from dat_segmentation_tpu_torch.parallel import process_shard_info

    cfg = tiny_seg(get_config)
    inf = SegInferencer(_model(cfg, weights), num_classes=NUM_CLASSES,
                        compute_dtype=torch.float32, device="cpu")
    return evaluate_dataset(inf, ADE20KDataset(root, "val"), num_classes=NUM_CLASSES,
                            max_images=max_images, shard_info=process_shard_info(),
                            distributed=True, verbose=False)


def trainer_cfg(get_config, root, work, fsdp=False, mesh_shape=None, drop=0.1):
    from dat_segmentation_tpu_torch.configs.schema import replace

    cfg = tiny_seg(get_config, num_classes=150, drop=drop)
    if mesh_shape is not None:
        cfg = dataclasses.replace(cfg, mesh_shape=mesh_shape)
    return replace(cfg, work_dir=str(work), name="dp", fsdp=fsdp,
                   **{
        "data.data_root": str(root), "data.batch_size": 4, "data.crop_size": (64, 64),
        "data.num_workers": 1, "schedule.max_iters": 4, "log_interval": 1,
        "checkpoint_interval": 2, "eval_interval": 2})


def train(rank, world, *, root, work, max_iters, sigterm_after=None, resume=False, fsdp=False,
          wait_for=None, mesh_shape=None, drop=0.1):
    """``train_segmentation`` of the tiny UperNet (150 classes) on the
    fixture, global batch 4, val on two images, on the mesh ``mesh_shape``,
    drop path and the heads' dropout at ``drop``;
    with ``sigterm_after`` rank 1 sends itself SIGTERM after that many
    steps; ``wait_for``: a file to wait for first (a checkpoint another
    process writes). Returns the step reached, the history, the in-run
    val's counts, the checkpoint directories present at the end, the
    model's whole state at the end and, resumed, right after the
    restore."""
    import time

    from dat_segmentation_tpu_torch import get_config
    from dat_segmentation_tpu_torch.parallel import mesh
    from dat_segmentation_tpu_torch.train import trainer_seg

    end = time.time() + 240
    while wait_for is not None and not Path(wait_for).exists():
        if time.time() > end:
            raise TimeoutError(wait_for)
        time.sleep(0.2)
    cfg = trainer_cfg(get_config, root, work, fsdp=fsdp, mesh_shape=mesh_shape, drop=drop)
    real = trainer_seg.make_train_step
    real_eval = trainer_seg.evaluate_dataset
    vals = []

    def evaluate(*a, **k):
        res = real_eval(*a, **k)
        vals.append({key: res[key] for key in ("inter", "union", "num_images")})
        return res

    def make(*a, **k):
        step = real(*a, **k)

        def signalled(state, batch):
            out = step(state, batch)
            if rank == 1 and state.step == sigterm_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return signalled

    restored = {}
    real_restore = trainer_seg._restore_state

    def restore(st, saved):
        out = real_restore(st, saved)
        restored.update(_numpy(mesh.full_state(st.model, everywhere=True)[0]))
        return out

    trainer_seg.make_train_step, trainer_seg._restore_state = make, restore
    trainer_seg.evaluate_dataset = evaluate
    try:
        state, hist = trainer_seg.train_segmentation(cfg, device="cpu", max_iters=max_iters,
                                                     eval_max_images=2, resume=resume)
    finally:
        trainer_seg.make_train_step, trainer_seg._restore_state = real, real_restore
        trainer_seg.evaluate_dataset = real_eval
    ckpts = sorted(p.name for p in (Path(work) / "dp").glob("ckpt_*"))
    return {"step": state.step, "history": hist, "ckpts": ckpts, "restored": restored,
            "vals": vals, "state": _numpy(mesh.full_state(state.model, everywhere=True)[0])}
