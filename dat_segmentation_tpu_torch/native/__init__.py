"""The port's native image ops (``imageops.cpp``), built with g++ at first
use and bound with ctypes.

Counterpart of ``dat_segmentation_tpu/native/__init__.py`` for the two ops
the train transform runs: ``photometric_distortion_u8`` and
``normalize_pad_f32``. The library is compiled with the JAX package's
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
