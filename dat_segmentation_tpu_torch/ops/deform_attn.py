"""Fused deformable attention: forward (kernel K1), backward (kernel K2)
and their plain versions.

K1 replaces the TPU kernel ``fused_deform_attention_v2``
(``dat_segmentation_tpu/ops/pallas/deform_attn.py:711``; its round-1 form
``fused_deform_attention_fwd``, ``:811``, computes the same function
without ``hn``/``wn``), K2 the TPU kernel ``fused_deform_attention_bwd_v2``
(``:1420``). The CUDA sources are ``csrc/deform_attn_fwd.cu`` and
``csrc/deform_attn_bwd.cu``; their headers say what bounds each kernel on
the card and what its design does about it. For every batch*group, head
and query K1 computes

    softmax(q·kᵀ·scale + bias) · v

where ``bias`` samples the head's (th, tw) relative-position table
bilinearly at half the query-to-sample displacement, with taps outside the
table weighing zero. When a gradient is wanted, K1 also writes each
query's log-sum-exp of the scores; K2 takes P from it and the output, a
chunk of samples at a time, and returns the gradients of q, k, v, pos and
the table. The scores, the bias and P never reach device memory.

``deform_attn`` runs through the op ``dat::deform_attn_fwd`` when no
gradient is wanted (serving): a ``torch.library`` custom op with a fake
function for its shape, so that graph capture (``torch.export``) keeps it
as one node on either device; its CUDA implementation is K1 alone, its CPU
one the plain version. When a gradient is wanted it runs through
``DeformAttnFunction`` on CUDA tensors, whose forward launches K1 (with the
log-sum-exp) and whose backward launches K2 (``deform_attn_bwd``), and on
CPU tensors through the plain version ``deform_attn_reference``, which
autograd differentiates. It never falls back from one to the other. The plain version is ``_xla_reference``
(``:1549``) written in PyTorch; ``deform_attn_bwd_reference`` is autograd
of it. They are what the tests hold to the JAX package and what
``chip_smoke.py`` holds the kernels to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .grid_sample import lerp_weight_matrix

SOURCE = "deform_attn_fwd.cu"
BWD_SOURCE = "deform_attn_bwd.cu"
HEAD_WIDTH = 32  # the kernel's head width (every DAT++ preset: dims / heads)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def query_coords(n: int, n_true: int, device=None) -> torch.Tensor:
    """Normalised query coordinates of rows (or columns) 0..n-1; corners of
    the true extent ``n_true`` at exactly -1 and +1.

    A correctly rounded division on every device, as the JAX package and
    the kernels compute it: on the card PyTorch divides by a Python number
    as a multiplication by its reciprocal, an ulp off at some rows, which
    moves the bias gradient by a tap's slope wherever a table coordinate
    lies that close to an integer."""
    idx = torch.arange(n, dtype=torch.float32, device=device)
    return idx / torch.full((), max(n_true - 1.0, 1.0), device=device) * 2.0 - 1.0


def rpe_bias(
    pos: torch.Tensor, table: torch.Tensor, H: int, W: int, hn: int = 0, wn: int = 0
) -> torch.Tensor:
    """The continuous relative-position bias, (BG, h_g, H*W, Ns), float32
    (float64 for float64 ``pos``).

    ``pos`` (BG, Ns, 2) holds normalised (y, x) sample positions; ``table``
    (g, h_g, th, tw) one table per head, group ``b % g`` for batch*group b.
    The table is sampled at 0.5 * (query - sample), through the tap-weight
    products of the JAX reference.
    """
    hn, wn = hn or H, wn or W
    return rpe_bias_at(pos, table, query_coords(H, hn, pos.device)[None],
                       query_coords(W, wn, pos.device)[None])


def rpe_bias_at(pos: torch.Tensor, table: torch.Tensor, qy: torch.Tensor,
                qx: torch.Tensor) -> torch.Tensor:
    """``rpe_bias`` at the normalised query rows ``qy`` (1 or BG, H) and
    columns ``qx`` (1 or BG, W): per batch*group under exact padded
    inference, whose query grid spans each sample's true extent."""
    BG, Ns, _ = pos.shape
    g, h_g, th, tw = table.shape
    H, W = qy.shape[1], qx.shape[1]
    dt = torch.promote_types(pos.dtype, torch.float32)
    pos = pos.to(dt)
    dy = (qy.to(dt)[:, :, None] - pos[..., 0][:, None, :]) * 0.5  # (BG, H, Ns)
    dx = (qx.to(dt)[:, :, None] - pos[..., 1][:, None, :]) * 0.5  # (BG, W, Ns)
    fy = (dy + 1.0) * 0.5 * (th - 1)
    fx = (dx + 1.0) * 0.5 * (tw - 1)
    wy = lerp_weight_matrix(fy, th, dt).reshape(BG // g, g, H, Ns, th)
    wx = lerp_weight_matrix(fx, tw, dt).reshape(BG // g, g, W, Ns, tw)
    m1 = torch.einsum("bgynt,ghtu->bgynuh", wy, table.to(dt))
    bias = torch.einsum("bgynuh,bgwnu->bghywn", m1, wx)  # (B, g, h_g, H, W, Ns)
    return bias.reshape(BG, h_g, H * W, Ns)


def deform_attn_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    table: torch.Tensor,
    *,
    n_groups: int,
    scale: float,
    hn: int = 0,
    wn: int = 0,
    return_lse: bool = False,
):
    """Plain PyTorch version of K1 (the JAX ``_xla_reference``).

    q (BG, H, W, Cg); k, v (BG, Ns, Cg); pos (BG, Ns, 2) normalised (y, x);
    table (g, h_g, th, tw). Products and the softmax in float32 (float64
    for float64 inputs, which the tests use as ground truth); the output
    has q's shape and dtype. ``return_lse``: also each query's log-sum-exp
    of the scores, (BG, h_g, H*W) in the compute dtype, as K1 writes it
    for K2.
    """
    BG, H, W, Cg = q.shape
    Ns = k.shape[1]
    g, h_g = table.shape[:2]
    hc = Cg // h_g
    assert g == n_groups and BG % g == 0, (q.shape, table.shape, n_groups)
    dt = torch.promote_types(q.dtype, torch.float32)
    qh = q.reshape(BG, H * W, h_g, hc).to(dt)
    kh = k.reshape(BG, Ns, h_g, hc).to(dt)
    vh = v.reshape(BG, Ns, h_g, hc)
    attn = torch.einsum("bmhc,bnhc->bhmn", qh, kh) * scale
    attn = attn + rpe_bias(pos, table, H, W, hn, wn).to(dt)
    p = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhmn,bnhc->bmhc", p.to(v.dtype).to(dt), vh.to(dt))
    out = out.reshape(BG, H, W, Cg).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(attn, dim=-1)
    return out


def deform_attn_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    table: torch.Tensor,
    dout: torch.Tensor,
    *,
    n_groups: int,
    scale: float,
    hn: int = 0,
    wn: int = 0,
):
    """Plain PyTorch version of K2: autograd of ``deform_attn_reference``.

    Returns (dq, dk, dv, dpos, dtable), each in its input's dtype.
    """
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, pos, table)]
    with torch.enable_grad():
        out = deform_attn_reference(
            *leaves, n_groups=n_groups, scale=scale, hn=hn, wn=wn
        )
        return torch.autograd.grad(out, leaves, dout)


def _check(q, k, v, pos, table, n_groups, hn, wn):
    BG, H, W, Cg = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"deform_attn: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("table", table)):
        if t.dtype != q.dtype:
            raise TypeError(f"deform_attn: {name} is {t.dtype}, q is {q.dtype}")
    if pos.dtype != torch.float32:
        raise TypeError(f"deform_attn: pos must be float32, got {pos.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos), ("table", table)):
        if t.device != q.device:
            raise ValueError(f"deform_attn: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"deform_attn: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"deform_attn: {name} must be 16-byte aligned")
    if k.ndim != 3 or k.shape[0] != BG or k.shape[2] != Cg or v.shape != k.shape:
        raise ValueError(f"deform_attn: k, v {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    Ns = k.shape[1]
    if tuple(pos.shape) != (BG, Ns, 2):
        raise ValueError(f"deform_attn: pos {tuple(pos.shape)}, want {(BG, Ns, 2)}")
    if table.ndim != 4 or table.shape[0] != n_groups or BG % n_groups:
        raise ValueError(f"deform_attn: table {tuple(table.shape)} does not match "
                         f"{n_groups} groups and batch*groups {BG}")
    if Cg != table.shape[1] * HEAD_WIDTH:
        raise ValueError(f"deform_attn: the kernel takes heads of {HEAD_WIDTH} "
                         f"channels; Cg {Cg} with {table.shape[1]} heads per group")
    if not (0 <= hn <= H and 0 <= wn <= W):
        raise ValueError(f"deform_attn: hn, wn ({hn}, {wn}) outside q's {H}x{W}")


@functools.lru_cache(maxsize=None)
def _library(defines=()) -> ctypes.CDLL:
    """K1's library; ``defines`` build an attribution variant of it
    (``csrc/deform_attn_fwd.cu``'s header), which only ``chip_smoke.py``
    times."""
    from . import cuda_build

    lib = cuda_build.load(SOURCE, defines)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # q, k, v, pos, table, out, lse; BG H W Ns Cg g h_g th tw hn wn; scale; dtype; stream
    lib.dat_deform_attn_fwd.argtypes = [ptr] * 7 + [i32] * 11 + [ctypes.c_float, i32, ptr]
    lib.dat_deform_attn_fwd.restype = i32
    lib.dat_deform_attn_fwd_smem_bytes.argtypes = [i32] * 4
    lib.dat_deform_attn_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.dat_deform_attn_fwd_chunk.argtypes = [i32] * 4
    lib.dat_deform_attn_fwd_chunk.restype = i32
    lib.dat_deform_attn_fwd_resident_blocks.argtypes = [i32] * 4
    lib.dat_deform_attn_fwd_resident_blocks.restype = i32
    lib.dat_deform_attn_fwd_warps_per_block.argtypes = [i32]
    lib.dat_deform_attn_fwd_warps_per_block.restype = i32
    lib.dat_cuda_error_string.argtypes = [i32]
    lib.dat_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library(defines=()) -> ctypes.CDLL:
    """K2's library; ``defines`` build an attribution variant of it
    (``csrc/deform_attn_bwd.cu``'s header), which only ``chip_smoke.py``
    times."""
    from . import cuda_build

    lib = cuda_build.load(BWD_SOURCE, defines)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # q k v pos table out lse dout dq dk dv dpos dtable; BG H W Ns Cg g h_g th tw hn wn;
    # scale; dtype; stream
    lib.dat_deform_attn_bwd.argtypes = [ptr] * 13 + [i32] * 11 + [ctypes.c_float, i32, ptr]
    lib.dat_deform_attn_bwd.restype = i32
    lib.dat_deform_attn_bwd_smem_bytes.argtypes = [i32] * 3
    lib.dat_deform_attn_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.dat_deform_attn_bwd_resident_blocks.argtypes = [i32] * 3
    lib.dat_deform_attn_bwd_resident_blocks.restype = i32
    lib.dat_deform_attn_bwd_warps_per_block.argtypes = []
    lib.dat_deform_attn_bwd_warps_per_block.restype = i32
    lib.dat_cuda_error_string.argtypes = [i32]
    lib.dat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(dtype: torch.dtype, Ns: int, th: int, tw: int) -> int:
    """Dynamic shared memory a block of K1 takes (builds it)."""
    return _library().dat_deform_attn_fwd_smem_bytes(_DTYPE_CODE[dtype], Ns, th, tw)


def fwd_chunk(dtype: torch.dtype, Ns: int, th: int, tw: int) -> int:
    """Samples a block of K1 takes a chunk, with an online softmax across
    chunks: bf16 64 (Ns if fewer); float32 Ns when the head's K and V fit
    in shared memory beside its table, fewer when they do not (builds it)."""
    return _library().dat_deform_attn_fwd_chunk(_DTYPE_CODE[dtype], Ns, th, tw)


def fwd_resident_warps(dtype: torch.dtype, Ns: int, th: int, tw: int):
    """(blocks, warps) of K1 resident on one SM of the current card, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (builds it)."""
    lib = _library()
    blocks = lib.dat_deform_attn_fwd_resident_blocks(_DTYPE_CODE[dtype], Ns, th, tw)
    return blocks, blocks * lib.dat_deform_attn_fwd_warps_per_block(_DTYPE_CODE[dtype])


def bwd_smem_bytes(dtype: torch.dtype, th: int, tw: int) -> int:
    """Dynamic shared memory a block of K2 takes, for any Ns (builds it)."""
    return _bwd_library().dat_deform_attn_bwd_smem_bytes(_DTYPE_CODE[dtype], th, tw)


def bwd_resident_warps(dtype: torch.dtype, th: int, tw: int):
    """(blocks, warps) of K2 resident on one SM of the current card, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (builds it)."""
    lib = _bwd_library()
    blocks = lib.dat_deform_attn_bwd_resident_blocks(_DTYPE_CODE[dtype], th, tw)
    return blocks, blocks * lib.dat_deform_attn_bwd_warps_per_block()


def _launch_error(kernel, lib, rc, q, Ns, th, tw, smem):
    return RuntimeError(
        f"{kernel} kernel not launched: {lib.dat_cuda_error_string(rc).decode()} "
        f"(q {tuple(q.shape)} {q.dtype}, Ns {Ns}, table {th}x{tw}: "
        f"{smem} bytes of shared memory a block)"
    )


def _fwd_launch(lib, q, k, v, pos, table, n_groups, scale, hn, wn, with_lse=False):
    """Launch a K1 library on checked CUDA tensors; uncounted."""
    BG, H, W, Cg = q.shape
    Ns = k.shape[1]
    g, h_g, th, tw = table.shape
    out = torch.empty_like(q)
    lse = torch.empty((BG, h_g, H * W), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dat_deform_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            table.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            BG, H, W, Ns, Cg, g, h_g, th, tw, hn or H, wn or W,
            float(scale), _DTYPE_CODE[q.dtype], stream,
        )
    if rc != 0:
        raise _launch_error("deform_attn_fwd", lib, rc, q, Ns, th, tw,
                            lib.dat_deform_attn_fwd_smem_bytes(_DTYPE_CODE[q.dtype], Ns, th, tw))
    return (out, lse) if with_lse else out


def _fwd_kernel(q, k, v, pos, table, n_groups, scale, hn, wn, with_lse=False):
    """Launch K1 on checked CUDA tensors: the output, and with ``with_lse``
    also each query's log-sum-exp, (BG, h_g, H*W) float32."""
    _check(q, k, v, pos, table, n_groups, hn, wn)
    res = _fwd_launch(_library(), q, k, v, pos, table, n_groups, scale, hn, wn, with_lse)
    deform_attn.launches += 1
    return res


def _bwd_launch(lib, q, k, v, pos, table, dout, out, lse, n_groups, scale, hn, wn):
    """Launch a K2 library on checked CUDA tensors; uncounted."""
    BG, H, W, Cg = q.shape
    Ns = k.shape[1]
    g, h_g, th, tw = table.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, **f32)  # summed over the sample chunks
    dk = torch.zeros(k.shape, **f32)
    dv = torch.zeros(v.shape, **f32)
    dpos = torch.zeros(pos.shape, **f32)
    dtable = torch.zeros(table.shape, **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dat_deform_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            table.data_ptr(), out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dpos.data_ptr(), dtable.data_ptr(),
            BG, H, W, Ns, Cg, g, h_g, th, tw, hn or H, wn or W,
            float(scale), _DTYPE_CODE[q.dtype], stream,
        )
    if rc != 0:
        raise _launch_error("deform_attn_bwd", lib, rc, q, Ns, th, tw,
                            lib.dat_deform_attn_bwd_smem_bytes(_DTYPE_CODE[q.dtype], th, tw))
    return dq.to(q.dtype), dk, dv, dpos, dtable


def deform_attn_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    table: torch.Tensor,
    dout: torch.Tensor,
    *,
    n_groups: int,
    scale: float,
    hn: int = 0,
    wn: int = 0,
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
):
    """K2 on CUDA tensors, its plain version on CPU tensors.

    Returns (dq, dk, dv, dpos, dtable): dq in q's dtype, the rest float32
    (the kernel sums them in float32 across query runs and sample chunks
    and, for dtable, across the batch). Shapes as in
    ``deform_attn_reference``; ``dout`` like q. ``out`` and ``lse`` are
    K1's output and log-sum-exp for these inputs (``DeformAttnFunction``
    saves them); on the card, without them, K1 is launched for them first.
    """
    if q.device.type == "cpu":
        return deform_attn_bwd_reference(
            q, k, v, pos, table, dout, n_groups=n_groups, scale=scale, hn=hn, wn=wn
        )
    if q.device.type != "cuda":
        raise ValueError(f"deform_attn_bwd runs on cuda or cpu, not {q.device}")
    _check(q, k, v, pos, table, n_groups, hn, wn)
    if out is None or lse is None:
        out, lse = _fwd_kernel(q, k, v, pos, table, n_groups, scale, hn, wn, with_lse=True)
    BG, H, W, _ = q.shape
    for name, t, shape, dtype in (("dout", dout, q.shape, q.dtype), ("out", out, q.shape, q.dtype),
                                  ("lse", lse, (BG, table.shape[1], H * W), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"deform_attn_bwd: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {tuple(shape)} {dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"deform_attn_bwd: {name} must be contiguous and 16-byte aligned")
    grads = _bwd_launch(_bwd_library(), q, k, v, pos, table, dout, out, lse,
                        n_groups, scale, hn, wn)
    deform_attn_bwd.launches += 1
    return grads


class DeformAttnFunction(torch.autograd.Function):
    """K1 forward, K2 backward, on CUDA tensors.

    The table is cast to q's dtype for both kernels; its gradient comes
    back in the table's own dtype, pos's in float32. The inputs, the
    output and K1's log-sum-exp (one float a query and head) are saved:
    K2 takes P from them a chunk of samples at a time, and the (HW x Ns)
    attention is never kept.
    """

    @staticmethod
    def forward(ctx, q, k, v, pos, table, n_groups, scale, hn, wn):
        table_k = table.to(q.dtype).contiguous()
        out, lse = _fwd_kernel(q, k, v, pos, table_k, n_groups, scale, hn, wn, with_lse=True)
        ctx.save_for_backward(q, k, v, pos, table_k, out, lse)
        ctx.args = (n_groups, scale, hn, wn, table.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pos, table_k, out, lse = ctx.saved_tensors
        n_groups, scale, hn, wn, table_dtype = ctx.args
        dq, dk, dv, dpos, dtable = deform_attn_bwd(
            q, k, v, pos, table_k, dout.contiguous(),
            n_groups=n_groups, scale=scale, hn=hn, wn=wn, out=out, lse=lse,
        )
        return (dq, dk.to(k.dtype), dv.to(v.dtype), dpos, dtable.to(table_dtype),
                None, None, None, None)


@torch.library.custom_op("dat::deform_attn_fwd", mutates_args=(), device_types="cpu")
def _deform_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                        table: torch.Tensor, n_groups: int, scale: float, hn: int,
                        wn: int) -> torch.Tensor:
    """``dat::deform_attn_fwd``, K1 without autograd; on the CPU its plain
    version (the table in its own dtype, as the plain version takes it)."""
    return deform_attn_reference(q, k, v, pos, table, n_groups=n_groups, scale=scale,
                                 hn=hn, wn=wn)


@_deform_attn_fwd_op.register_kernel("cuda")
def _deform_attn_fwd_cuda(q, k, v, pos, table, n_groups, scale, hn, wn):
    return _fwd_kernel(q, k, v, pos, table.to(q.dtype).contiguous(), n_groups, scale, hn, wn)


@_deform_attn_fwd_op.register_fake
def _deform_attn_fwd_fake(q, k, v, pos, table, n_groups, scale, hn, wn):
    return torch.empty_like(q)


def deform_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: torch.Tensor,
    table: torch.Tensor,
    *,
    n_groups: int,
    scale: float,
    hn: int = 0,
    wn: int = 0,
) -> torch.Tensor:
    """K1 (with K2 as its gradient when one is wanted) on CUDA tensors, the
    plain version on CPU tensors.

    Shapes as in ``deform_attn_reference``. ``hn``/``wn`` are the true
    height and width when q's rows and columns were padded (0: unpadded).
    On the card the table may be float32 (a master weight) while q, k and
    v are bf16: the kernels take it in q's dtype. Without a gradient the
    call is the op ``dat::deform_attn_fwd`` on either device.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deform_attn runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, pos, table)):
        if q.device.type == "cpu":
            return deform_attn_reference(
                q, k, v, pos, table, n_groups=n_groups, scale=scale, hn=hn, wn=wn
            )
        return DeformAttnFunction.apply(q, k, v, pos, table, n_groups, float(scale), hn, wn)
    return torch.ops.dat.deform_attn_fwd(q, k, v, pos, table, n_groups, float(scale), hn, wn)


# K1 launches by this wrapper (a CUDA graph's capture counts; its replays,
# which launch K1 without it, do not); chip_smoke.py reads and resets it
deform_attn.launches = 0
deform_attn_bwd.launches = 0  # K2 launches; likewise
