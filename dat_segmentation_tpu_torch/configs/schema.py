"""Dataclass config schema of the PyTorch port.

A copy of ``dat_segmentation_tpu/configs/schema.py``: the port keeps its
own copy so that it imports nothing of the JAX package, and
``tests/test_torch_models.py`` holds every preset equal to the JAX one
field by field. ``kernel_impl`` is read by the backbone: ``'pallas'``
runs the fused X-block kernel K3 (``ops/x_block.py``) where the JAX
package's gate lets it; ``'xla'``, ``'auto'`` (the presets' value) and
``'gather'`` run the unfused chain, as the JAX package does on every
backend but the TPU. The deformable-attention kernels K1 and K2 run on the
card whatever the value; on the CPU every kernel is its plain version.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union


def _quad(v) -> Tuple:
    """Broadcast a scalar to a 4-tuple (per-stage)."""
    if isinstance(v, (list, tuple)):
        assert len(v) == 4, v
        return tuple(v)
    return (v,) * 4


@dataclass(frozen=True)
class BackboneConfig:
    """All DAT backbone knobs (reference: models/backbones/dat.py:169-203)."""

    img_size: int = 224
    patch_size: int = 4
    expansion: int = 4
    dim_stem: int = 96
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_sizes: Tuple[int, ...] = (7, 7, 7, 7)
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    strides: Tuple[int, ...] = (-1, -1, -1, -1)
    offset_range_factor: Tuple[float, ...] = (1, 2, 3, 4)
    stage_spec: Tuple[Tuple[str, ...], ...] = (
        ("L", "D"), ("L", "D"), ("L", "D", "L", "D", "L", "D"), ("L", "D"),
    )
    groups: Tuple[int, ...] = (-1, -1, 3, 6)
    use_pes: Tuple[bool, ...] = (False,) * 4
    dwc_pes: Tuple[bool, ...] = (False,) * 4
    fixed_pes: Tuple[bool, ...] = (False,) * 4
    no_offs: Tuple[bool, ...] = (False,) * 4
    use_dwc_mlps: Tuple[bool, ...] = (False,) * 4
    use_conv_patches: bool = False
    ksizes: Tuple[int, ...] = (9, 7, 5, 3)
    layer_scale_values: Tuple[float, ...] = (-1, -1, -1, -1)
    use_lpus: Tuple[bool, ...] = (False,) * 4
    use_cmt_mlps: Tuple[bool, ...] = (False,) * 4
    log_cpb: Tuple[bool, ...] = (False,) * 4
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    use_checkpoint: bool = False
    kernel_impl: str = "xla"  # 'xla' | 'pallas'


@dataclass(frozen=True)
class HeadConfig:
    """Decode / auxiliary / cls head spec; ``type`` keys the head registry."""

    type: str = "UPerHead"
    num_classes: int = 150
    channels: int = 512
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class NeckConfig:
    type: str = "FPN"
    out_channels: int = 256


@dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    decode_head: HeadConfig = field(default_factory=HeadConfig)
    auxiliary_head: Optional[HeadConfig] = None
    neck: Optional[NeckConfig] = None
    align_corners: bool = False
    aux_in_index: int = 2
    aux_loss_weight: float = 0.4
    num_classes: int = 150
    # inference (reference test_cfg; mmseg mode='whole'|'slide')
    test_mode: str = "whole"
    crop_size: Tuple[int, int] = (512, 512)
    slide_stride: Tuple[int, int] = (341, 341)
    pretrained: Optional[str] = None


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW with no-decay param labels (reference: new_train.py:145-159,
    configs/dat/upn_tiny_160k_dp03_lr6.py:43-48)."""

    lr: float = 6e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    no_decay_keys: Tuple[str, ...] = (
        "absolute_pos_embed",
        "relative_position_bias_table",
        "rpe_table",
        "norm",
        # this repo's LN scope spellings (see train/optim.py docstring);
        # the effective no-decay SET equals the reference's name rule
        "stem_ln",
        "offset_ln",
        "down_ln",
        "ln_cnvnxt",
    )
    grad_clip: Optional[float] = None


@dataclass(frozen=True)
class ScheduleConfig:
    """Warmup + poly (seg) or cosine (cls) LR schedules
    (reference: new_train.py:20-50, train_backbone.py:250-264)."""

    policy: str = "poly"  # 'poly' | 'cosine'
    max_iters: int = 160_000
    warmup_iters: int = 1500
    warmup_ratio: float = 1e-6
    power: float = 1.0
    min_lr: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "ade20k"
    data_root: str = ""
    crop_size: Tuple[int, int] = (512, 512)
    img_scale: Tuple[int, int] = (2048, 512)  # (W, H)
    ratio_range: Tuple[float, float] = (0.5, 2.0)
    cat_max_ratio: float = 0.75
    ignore_index: int = 255
    batch_size: int = 16  # global (reference: 2 imgs/GPU x 8 GPUs)
    # 0 = auto-size to the host: min(32, cpu_count) threads, matching the
    # reference's workers=32 on real TPU-VM hosts (100+ cores) while not
    # oversubscribing small ones (aug throughput scales linearly with
    # threads until cores saturate — tools/bench_data.py)
    num_workers: int = 0
    reduce_zero_label: bool = True


@dataclass(frozen=True)
class TrainConfig:
    name: str = "upn_tiny_160k"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    seed: int = 0
    log_interval: int = 50
    checkpoint_interval: int = 16_000
    eval_interval: int = 16_000
    work_dir: str = "work_dirs"
    dtype: str = "bfloat16"  # compute dtype on TPU; params stay fp32
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": -1})
    # ZeRO-style param+optimizer sharding (parallel/mesh.py:fsdp_sharding):
    # False = replicate (DDP-equivalent), True = shard over 'data'
    # (per-chip optimizer memory drops by the data-axis size), or a mesh
    # axis NAME — 'model' on a {'data': X, 'model': Y} mesh is tensor
    # parallelism (GSPMD all-reduces partial matmuls over 'model').
    fsdp: Union[bool, str] = False


def replace(cfg, **kwargs):
    """dataclasses.replace that tolerates nested dotted keys ('model.backbone.dims')."""
    for key, value in kwargs.items():
        parts = key.split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{key: value})
        else:
            child = getattr(cfg, parts[0])
            cfg = dataclasses.replace(
                cfg, **{parts[0]: replace(child, **{".".join(parts[1:]): value})}
            )
    return cfg
