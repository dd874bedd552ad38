"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file is a plain-C shared library, compiled by ``nvcc``
for ``sm_90a`` (Hopper) into ``dat_segmentation_tpu_torch/_build/``,
under a name keyed by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. ``defines``
(``-D`` macros) build a variant of a source beside it, under its own
name. The headers of ``csrc/`` (``*.cuh``) are part of every source's
hash. Nothing is built or loaded when this module is imported: the CPU
has no ``nvcc``, and the tests import every module.

A library built elsewhere (a serving artifact's ``kernels/``) is loaded in
place of a build once ``use_prebuilt`` has registered it, which it does
only for a library whose digest is the installed source's: ``load`` then
checks its sha256 and never calls ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "sm_90a"  # Hopper with wgmma: runs only on compute capability 9.0
CAPABILITY = (9, 0)

NVCC_FLAGS = (
    "-gencode", f"arch=compute_90a,code={ARCH}",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME`` (default ``/usr/local/cuda``) or PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin or PATH): the port's kernels are "
            "built from csrc/ at first use on a machine with the CUDA toolkit"
        )
    return found


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def digest(source: str, defines=()) -> str:
    """16 hex digits of ``csrc/<source>``, every ``csrc/*.cuh`` and the
    flags: the key of a library built from them."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(
        (CSRC / source).read_bytes() + headers + " ".join(_flags(defines)).encode()
    ).hexdigest()[:16]


def library_path(source: str, defines=()) -> Path:
    """Where ``source``'s library (built with ``defines``) lives once built."""
    variant = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"{Path(source).stem}{variant}-{digest(source, defines)}.so"


def file_sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def check_card(device=None) -> None:
    """Raise unless ``device`` (default: the current card) is compute
    capability 9.0, the only one ``sm_90a`` code runs on."""
    import torch

    cap = tuple(torch.cuda.get_device_capability(device))
    if cap != CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} is compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels are {ARCH} code, which runs only on "
            f"{CAPABILITY[0]}.{CAPABILITY[1]} (Hopper)"
        )


_PREBUILT = {}  # (source, defines) -> (path, sha256): taken by ``load`` before a build


def use_prebuilt(source: str, defines, path, sha256: str) -> None:
    """Have ``load`` take the library at ``path`` (sha256 ``sha256``) for
    ``source`` built with ``defines``. The caller has checked that it was
    built from the installed source (``digest``): a library of another
    source may have another C interface."""
    _PREBUILT[(source, tuple(defines))] = (Path(path), sha256)


def build(source: str, defines=()) -> Path:
    """Compile ``csrc/<source>`` (with ``-D`` ``defines``) unless its
    library exists; return its path.

    The compiler's output (``-Xptxas -v``) is kept beside the library as
    ``.log``. The library is written under a temporary name and renamed,
    so processes that build at once never load a half-written file.
    """
    so = library_path(source, defines)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *_flags(defines), "-o", str(tmp), str(CSRC / source)],
        capture_output=True,
        text=True,
    )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def build_log(source: str, defines=()) -> str:
    """The compiler output kept by ``build`` (empty if none was kept)."""
    log = library_path(source, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(source: str, defines=()) -> ctypes.CDLL:
    """Load ``csrc/<source>``'s library (with ``defines``, a tuple): the one
    ``use_prebuilt`` registered, after checking its sha256, else built if
    needed; one handle per process."""
    prebuilt = _PREBUILT.get((source, tuple(defines)))
    if prebuilt is None:
        return ctypes.CDLL(str(build(source, tuple(defines))))
    path, want = prebuilt
    got = file_sha256(path)
    if got != want:
        raise RuntimeError(f"{path}: sha256 {got}, its manifest says {want}")
    return ctypes.CDLL(str(path))
