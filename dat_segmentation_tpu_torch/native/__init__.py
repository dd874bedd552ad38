"""The port's native image ops (``imageops.cpp``), built with g++ at first
use and bound with ctypes.

Counterpart of ``dat_segmentation_tpu/native/__init__.py`` for the two ops
the seg train transform runs: ``photometric_distortion_u8`` and
``normalize_pad_f32``. Beside them, the two cv2 calls of the ImageNet
transforms (``data/imagenet.py``), which the JAX package makes through cv2:
``resize_cubic_u8`` (``cv2.resize`` with ``INTER_CUBIC``) and
``warp_affine_u8`` (``cv2.warpAffine``, bilinear, constant border), equal to
OpenCV's own C++ bit for bit. The library is compiled with the JAX package's
Makefile flags (``CXX_FLAGS``) into ``dat_segmentation_tpu_torch/_build/``,
under a name keyed by a hash of the source and the flags (as
``ops/cuda_build.py`` keys the CUDA libraries), so an edited source is
rebuilt. Nothing is built when this module is imported. Unlike the JAX
package, which falls back to cv2 when its library is missing, the port has
no second implementation: a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "imageops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"imageops-{digest}.so"


def build() -> Path:
    """Compile ``imageops.cpp`` unless its library exists; return its path.
    Written under a temporary name and renamed, so that processes (or
    loader threads) building at once never load a half-written file."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's train transform builds "
                           f"{SOURCE.name} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{id(so)}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the library; one handle per process."""
    lib = ctypes.CDLL(str(build()))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ci, cf = ctypes.c_int, ctypes.c_float
    lib.normalize_pad_f32.argtypes = [u8p, ci, ci, f32p, f32p, f32p, ci, ci, cf]
    lib.normalize_pad_f32.restype = None
    lib.photometric_distortion_u8.argtypes = [u8p, ci, ci, cf, cf, cf, cf, ci]
    lib.photometric_distortion_u8.restype = None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.resize_cubic_u8.argtypes = [u8p, ci, ci, ci, u8p, ci, ci, i32p, i16p, i32p, i16p]
    lib.resize_cubic_u8.restype = None
    lib.warp_affine_u8_c3.argtypes = [u8p, ci, ci, u8p, ci, ci, f32p, ci]
    lib.warp_affine_u8_c3.restype = None
    return lib


def normalize_pad_f32(img: np.ndarray, mean, std, oh: int, ow: int,
                      pad_value: float = 0.0) -> np.ndarray:
    """(img - mean) / std of an (h, w, 3) uint8 image into an (oh, ow, 3)
    float32 canvas at ``pad_value``, top-left aligned."""
    out = np.empty((oh, ow, 3), np.float32)
    stdinv = (1.0 / np.asarray(std, np.float32)).astype(np.float32)
    load().normalize_pad_f32(
        np.ascontiguousarray(img.astype(np.uint8)), img.shape[0], img.shape[1],
        np.asarray(mean, np.float32), stdinv, out, oh, ow, pad_value,
    )
    return out


def photometric_distortion_u8(img: np.ndarray, *, brightness=0.0, contrast=1.0,
                              saturation=1.0, hue=0.0, contrast_first=False) -> np.ndarray:
    """The photometric distortion of an (h, w, 3) uint8 RGB image in one
    pass: brightness delta, contrast (before the HSV step when
    ``contrast_first``, else after it), saturation factor, hue shift; a
    step is off at 0, 1, 1, 0."""
    out = np.ascontiguousarray(img.astype(np.uint8)).copy()
    load().photometric_distortion_u8(
        out, img.shape[0], img.shape[1], brightness, contrast, saturation, hue,
        int(contrast_first),
    )
    return out


def cubic_table(src_size: int, dst_size: int):
    """OpenCV's cubic resize table along one axis: per output index the
    first of its 4 source taps (unclamped) and the 4 coefficients (A =
    -0.75) times 2048, rounded half to even, as ``resize`` computes them in
    float32 (``interpolateCubic``; numpy's float32 arithmetic does not fuse,
    nor does OpenCV's here)."""
    scale = 1.0 / (dst_size / src_size)
    f = ((np.arange(dst_size, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    first = np.floor(f)
    x = f - first
    a = np.float32(-0.75)
    x1, y = x + np.float32(1), np.float32(1) - x
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    c3 = np.float32(1) - c0 - c1 - c2
    coef = np.rint(np.stack([c0, c1, c2, c3], 1) * np.float32(2048))
    return first.astype(np.int32) - 1, np.ascontiguousarray(coef.astype(np.int16))


def resize_cubic_u8(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC)`` of an
    (h, w[, c]) uint8 image, ``dsize`` = (width, height)."""
    dw, dh = int(dsize[0]), int(dsize[1])
    src = np.ascontiguousarray(img, np.uint8)
    h, w = src.shape[:2]
    cn = 1 if src.ndim == 2 else src.shape[2]
    if (dw, dh) == (w, h):
        return src.copy()
    if min(dw, dh, w, h) < 1:
        raise ValueError(f"resize of a {w}x{h} image to {dw}x{dh}")
    xofs, alpha = cubic_table(w, dw)
    yofs, beta = cubic_table(h, dh)
    out = np.empty((dh, dw) + src.shape[2:], np.uint8)
    load().resize_cubic_u8(src, h, w, cn, out, dh, dw, xofs, alpha, yofs, beta)
    return out


def invert_affine(m) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64, its arithmetic as OpenCV's."""
    m = np.asarray(m, np.float64).reshape(2, 3)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * det, m[0, 0] * det, -m[0, 1] * det, -m[1, 0] * det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def warp_affine_u8(img: np.ndarray, m, fill: int = 128, *, inverse_map: bool = True) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags=INTER_LINEAR [|
    WARP_INVERSE_MAP], borderMode=BORDER_CONSTANT, borderValue=(fill,)*3)``
    of an (h, w, 3) uint8 image. ``m`` maps output to input when
    ``inverse_map``, else input to output (then inverted in float64 first,
    as OpenCV does)."""
    src = np.ascontiguousarray(img, np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"warp_affine_u8 takes (h, w, 3) uint8, not {src.shape}")
    m = np.asarray(m, np.float64).reshape(2, 3)
    if not inverse_map:
        m = invert_affine(m)
    h, w = src.shape[:2]
    out = np.empty_like(src)
    load().warp_affine_u8_c3(src, h, w, out, h, w, np.ascontiguousarray(m, np.float32).ravel(),
                             int(fill))
    return out
