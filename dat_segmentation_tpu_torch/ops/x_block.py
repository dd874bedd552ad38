"""Fused X-block forward (kernel K3) and its plain version.

K3 replaces the TPU kernel ``_fwd_pallas``
(``dat_segmentation_tpu/ops/pallas/x_block.py:227``, reached through
``fused_x_block`` and ``fused_conv_mlp``). The CUDA source is
``csrc/x_block_fwd.cu``; its header says what bounds the kernel on the card
and what its design does about it. On an NHWC input x it computes

    x1  = x + dw3(x) + b3            (the local perception unit, optional)
    y   = dw_k(x1) + b7              (the window conv; identity in MLP mode)
    y   = LN(y) * g + be             (statistics in float32, eps 1e-5)
    h   = y @ W1ᵀ, then + b1         (C -> E = 4C)
    h   = h + dw3(h) + bd
    out = gelu(h) @ W2ᵀ + b2         (exact erf; E -> C)

with zero padding at every depthwise conv: x1 and h are zero outside the
image before the next conv reads them. In MLP-only mode (the second half of
a 'D' block) there is no LPU and no window conv: y = x.

``x_block_fwd`` is the op ``dat::x_block_fwd``: a ``torch.library``
custom op with a fake function for its shape, so that graph capture
(``torch.export``) keeps it as one node; K3 on a CUDA tensor (it launches
the kernel or raises, it never falls back), the plain version on a CPU
tensor. ``fused_x_block`` and ``fused_conv_mlp`` take the port's own
parameter tensors (depthwise ``Conv2d`` weights (C, 1, k, k),
``nn.Linear`` weights (out, in)); without a gradient they call
``x_block_fwd``, with one they run ``XBlockFunction``: its forward is
``x_block_fwd``, and its backward recomputes the plain version under
autograd, as the TPU wrapper's ``_fxb_bwd`` does with ``jax.vjp``. Only
(x, params) are saved.

``x_block_reference`` is the plain version, the JAX ``_composite`` (``:193``)
written in PyTorch. It works in x's dtype (the parameters are cast to it)
and rounds where ``_composite`` rounds: after each depthwise conv and its
residual, after the LayerNorm, after fc1's product (fc1's bias is added
after that cast), and after fc2 with its bias; LN statistics, the GELU and
the products' sums are float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

SOURCE = "x_block_fwd.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MODE_X_LPU, MODE_X, MODE_MLP = 0, 1, 2
LN_EPS = 1e-5  # LayerNorm2d's (nn.LayerNorm's default), as the JAX kernel's
CHANNEL_MULTIPLE = 32  # the kernel's channel chunk (every DAT++ width is a multiple)
MAX_CHANNELS = 1024
HIDDEN_MULTIPLE = 64  # the hidden width E = C x expansion, in fc1's and fc2's 64-wide tiles
WINDOWS = (1, 3, 5, 7, 9)  # the window sizes the kernel is instanced for
_PARAMS = ("w3", "b3", "w7", "b7", "g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")


def _dwconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise k x k conv of NHWC x with zero padding k // 2; w (C, 1, k, k)."""
    k = w.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=k // 2, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def x_block_reference(
    x: torch.Tensor,
    w3: Optional[torch.Tensor],
    b3: Optional[torch.Tensor],
    w7: Optional[torch.Tensor],
    b7: Optional[torch.Tensor],
    g: torch.Tensor,
    be: torch.Tensor,
    wf1: torch.Tensor,
    bf1: torch.Tensor,
    wd: torch.Tensor,
    bd: torch.Tensor,
    wf2: torch.Tensor,
    bf2: torch.Tensor,
    *,
    with_lpu: bool,
) -> torch.Tensor:
    """Plain PyTorch version of K3 (the JAX ``_composite``).

    x (B, H, W, C); w3 (C, 1, 3, 3) and b3 (C) the LPU when ``with_lpu``;
    w7 (C, 1, k, k) and b7 (C) the window conv, or both None for MLP-only
    mode (y = x); g, be (C) the LayerNorm; wf1 (E, C), bf1 (E); wd
    (E, 1, 3, 3), bd (E); wf2 (C, E), bf2 (C). Returns x's shape and dtype.
    """
    dt = x.dtype
    cast = [None if p is None else p.to(dt) for p in (w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2)]
    w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2 = cast
    if with_lpu:
        x = x + _dwconv(x, w3, b3)
    y = x if w7 is None else _dwconv(x, w7, b7)
    y32 = y.float()
    mean = y32.mean(-1, keepdim=True)
    var = (y32 - mean).square().mean(-1, keepdim=True)
    y = ((y32 - mean) * torch.rsqrt(var + LN_EPS) * g.float() + be.float()).to(dt)
    h = F.linear(y, wf1) + bf1
    h = h + _dwconv(h, wd, bd)
    h = F.gelu(h.float()).to(dt)
    return F.linear(h, wf2, bf2)


def _check(x, params, with_lpu, window):
    B, H, W, C = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x_block: x must be float32 or bfloat16, got {x.dtype}")
    if C % CHANNEL_MULTIPLE or C > MAX_CHANNELS:
        raise ValueError(f"x_block: the kernel takes C a multiple of {CHANNEL_MULTIPLE} "
                         f"up to {MAX_CHANNELS}, got {C}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x_block: x must be contiguous and 16-byte aligned")
    E = params["wf1"].shape[0]
    want = {"g": (C,), "be": (C,), "wf1": (E, C), "bf1": (E,), "wd": (E, 1, 3, 3),
            "bd": (E,), "wf2": (C, E), "bf2": (C,)}
    if with_lpu:
        want.update(w3=(C, 1, 3, 3), b3=(C,))
    if window:
        want.update(w7=(C, 1, window, window), b7=(C,))
    for name, shape in want.items():
        p = params[name]
        if tuple(p.shape) != shape:
            raise ValueError(f"x_block: {name} {tuple(p.shape)}, want {shape}")
        if p.device != x.device:
            raise ValueError(f"x_block: {name} is on {p.device}, x on {x.device}")
    if E % HIDDEN_MULTIPLE:
        raise ValueError(f"x_block: hidden width {E} is not a multiple of {HIDDEN_MULTIPLE}")
    if window and window not in WINDOWS:
        raise ValueError(f"x_block: window {window} not in {', '.join(map(str, WINDOWS))}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # x w3 b3 w7 b7 g be wf1 bf1 wd bd wf2 bf2 out; B H W C E k mode; eps; dtype; stream
    lib.dat_x_block_fwd.argtypes = [ptr] * 14 + [i32] * 7 + [ctypes.c_float, i32, ptr]
    lib.dat_x_block_fwd.restype = i32
    lib.dat_x_block_fwd_tile.argtypes = [i32] * 4
    lib.dat_x_block_fwd_tile.restype = i32
    lib.dat_x_block_fwd_smem_bytes.argtypes = [i32] * 5
    lib.dat_x_block_fwd_smem_bytes.restype = ctypes.c_longlong
    for fn in (lib.dat_x_block_fwd_resident_blocks, lib.dat_x_block_fwd_registers):
        fn.argtypes = [i32] * 4
        fn.restype = i32
    lib.dat_x_block_fwd_warps_per_block.argtypes = []
    lib.dat_x_block_fwd_warps_per_block.restype = i32
    lib.dat_cuda_error_string.argtypes = [i32]
    lib.dat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tile_rows(dtype: torch.dtype, C: int, mode: int, k: int) -> int:
    """Output rows of the kernel's (rows x 8)-pixel tile at these widths (builds it)."""
    return _library().dat_x_block_fwd_tile(_DTYPE_CODE[dtype], C, mode, k)


def smem_bytes(dtype: torch.dtype, C: int, mode: int, k: int) -> int:
    """Dynamic shared memory a block of K3 takes (builds it)."""
    lib = _library()
    th = lib.dat_x_block_fwd_tile(_DTYPE_CODE[dtype], C, mode, k)
    return lib.dat_x_block_fwd_smem_bytes(_DTYPE_CODE[dtype], C, mode, k, th)


def resident_warps(dtype: torch.dtype, C: int, mode: int, k: int):
    """(blocks, warps) of K3 resident on one SM of the current card at these
    widths, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (builds it)."""
    lib = _library()
    blocks = lib.dat_x_block_fwd_resident_blocks(_DTYPE_CODE[dtype], C, mode, k)
    return blocks, blocks * lib.dat_x_block_fwd_warps_per_block()


def registers(dtype: torch.dtype, C: int, mode: int, k: int) -> int:
    """Registers a thread of the kernel instance these widths launch (builds it)."""
    return _library().dat_x_block_fwd_registers(_DTYPE_CODE[dtype], C, mode, k)


def _vec(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p.to(dtype).contiguous()


@torch.library.custom_op("dat::x_block_fwd", mutates_args=(), device_types="cpu")
def _x_block_fwd_op(
    x: torch.Tensor,
    w3: Optional[torch.Tensor],
    b3: Optional[torch.Tensor],
    w7: Optional[torch.Tensor],
    b7: Optional[torch.Tensor],
    g: torch.Tensor,
    be: torch.Tensor,
    wf1: torch.Tensor,
    bf1: torch.Tensor,
    wd: torch.Tensor,
    bd: torch.Tensor,
    wf2: torch.Tensor,
    bf2: torch.Tensor,
    with_lpu: bool,
) -> torch.Tensor:
    """``dat::x_block_fwd``, K3 without autograd; on the CPU its plain version."""
    return x_block_reference(x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2,
                             with_lpu=with_lpu)


@_x_block_fwd_op.register_kernel("cuda")
def _x_block_fwd_cuda(x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2, with_lpu):
    """Launch K3 on checked CUDA tensors. For the kernel every parameter
    is cast to x's dtype (no copy when it already is, as in a bf16 serving
    model); the kernel reads every weight as the module stores it: the
    depthwise ones (C, 1, k, k), which it stages into shared memory a
    channel chunk at a time, and the linear ones (out, in), the column-major
    B operand of its products."""
    window = 0 if w7 is None else w7.shape[-1]
    params = dict(w3=w3, b3=b3, w7=w7, b7=b7, g=g, be=be, wf1=wf1, bf1=bf1, wd=wd, bd=bd,
                  wf2=wf2, bf2=bf2)
    _check(x, params, with_lpu, window)
    B, H, W, C = x.shape
    E = wf1.shape[0]
    dt = x.dtype
    mode = MODE_MLP if w7 is None else (MODE_X_LPU if with_lpu else MODE_X)
    k = window or 1
    args = [None if p is None else _vec(p, dt)
            for p in (w3 if with_lpu else None, b3 if with_lpu else None, w7, b7,
                      g, be, wf1, bf1, wd, bd, wf2, bf2)]
    for name, a in zip(_PARAMS, args):
        if a is not None and a.data_ptr() % 16:
            raise ValueError(f"x_block: {name} must be 16-byte aligned")
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dat_x_block_fwd(
            x.data_ptr(), *[None if a is None else a.data_ptr() for a in args], out.data_ptr(),
            B, H, W, C, E, k, mode, LN_EPS, _DTYPE_CODE[dt], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"x_block_fwd kernel not launched: {lib.dat_cuda_error_string(rc).decode()} "
            f"(x {tuple(x.shape)} {dt}, E {E}, k {k}, mode {mode}: "
            f"{smem_bytes(dt, C, mode, k)} bytes of shared memory a block)"
        )
    x_block_fwd.launches += 1
    return out


@_x_block_fwd_op.register_fake
def _x_block_fwd_fake(x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2, with_lpu):
    return torch.empty_like(x)


def x_block_fwd(
    x: torch.Tensor,
    w3: Optional[torch.Tensor],
    b3: Optional[torch.Tensor],
    w7: Optional[torch.Tensor],
    b7: Optional[torch.Tensor],
    g: torch.Tensor,
    be: torch.Tensor,
    wf1: torch.Tensor,
    bf1: torch.Tensor,
    wd: torch.Tensor,
    bd: torch.Tensor,
    wf2: torch.Tensor,
    bf2: torch.Tensor,
    *,
    with_lpu: bool,
) -> torch.Tensor:
    """K3 on a CUDA tensor, its plain version on a CPU tensor; no autograd
    (the op ``dat::x_block_fwd``). Arguments as in ``x_block_reference``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x_block runs on cuda or cpu, not {x.device}")
    return torch.ops.dat.x_block_fwd(x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2,
                                     with_lpu)


class XBlockFunction(torch.autograd.Function):
    """``x_block_fwd`` forward; backward by autograd of the plain version,
    recomputed from the saved (x, params). Absent parameters (no LPU, or
    no window conv in MLP-only mode) are None and get None."""

    @staticmethod
    def forward(ctx, x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2, with_lpu):
        params = (w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2)
        ctx.present = [p is not None for p in params]
        ctx.with_lpu = with_lpu
        ctx.save_for_backward(x, *[p for p in params if p is not None])
        return x_block_fwd(x, *params, with_lpu=with_lpu)

    @staticmethod
    def backward(ctx, dout):
        saved = iter(ctx.saved_tensors)
        x = next(saved).detach().requires_grad_(True)
        params = [next(saved).detach().requires_grad_(True) if here else None
                  for here in ctx.present]
        leaves = [x] + [p for p in params if p is not None]
        with torch.enable_grad():
            out = x_block_reference(x, *params, with_lpu=ctx.with_lpu)
            grads = iter(torch.autograd.grad(out, leaves, dout))
        dx = next(grads)
        dparams = [next(grads) if here else None for here in ctx.present]
        return (dx, *dparams, None)


def _apply(x, *params_and_lpu):
    """``XBlockFunction`` when a gradient is wanted, else ``x_block_fwd``."""
    *params, with_lpu = params_and_lpu
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, *params)):
        return XBlockFunction.apply(x, *params, with_lpu)
    return x_block_fwd(x, *params, with_lpu=with_lpu)


def fused_x_block(x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2, k, with_lpu):
    """The 'X' block's LPU + window conv + LN + ConvMLP in one kernel.

    The port's parameter tensors as they are (``lpu_d``, ``conv_attn_d``,
    ``ln_cnvnxt_d``, ``mlp_d.fc1/dwc/fc2``); ``w3``/``b3`` None when
    ``with_lpu`` is False. ``k`` is the window conv's size (w7's own).
    """
    if w7.shape[-1] != k:
        raise ValueError(f"fused_x_block: window {k}, but w7 is {tuple(w7.shape)}")
    return _apply(x, w3, b3, w7, b7, g, be, wf1, bf1, wd, bd, wf2, bf2, with_lpu)


def fused_conv_mlp(x, g, be, wf1, bf1, wd, bd, wf2, bf2):
    """LN -> fc1 -> residual dw3 -> GELU -> fc2 in one kernel (the 'D'
    block's second half; the caller applies LayerScale, drop path and the
    residual)."""
    return _apply(x, None, None, None, None, g, be, wf1, bf1, wd, bd, wf2, bf2, False)


# K3 launches by this wrapper (both modes; as K1's, a graph's replays are not
# counted); chip_smoke.py reads and resets it
x_block_fwd.launches = 0
