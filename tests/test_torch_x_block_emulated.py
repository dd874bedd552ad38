"""K3's CUDA source (``csrc/x_block_fwd.cu``) run on the CPU, against its
plain version.

The card is the only place the kernel runs for real. Here its source is
compiled with the host C++ compiler against ``tests/cuda_emu/`` (one OS
thread a CUDA thread, barriers for ``__syncthreads`` and the warp-wide
``ldmatrix``, ``mma.sync`` and shuffles; ``cp.async`` copies land only at
the wait that retires them) and run at small sizes, both modes, bf16 and
float32, on the paths the card takes: every tile height (16, 8 and 2 rows
in bf16; float32's 2), partial 64-wide weight tiles (C = 96), the widest
weight stream (C = 1024) and sides that are not tile multiples. What the
emulation cannot show (speed, the card's compiler, bank conflicts) is for
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Needs ``g++`` (C++20);
skips without it. Inputs are made with numpy from a seed; the tolerances
are the card's (``XB_TOL`` in ``test_torch_cuda.py``).
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dat_segmentation_tpu_torch.ops import x_block as xb

ROOT = Path(__file__).resolve().parent
EMU = ROOT / "cuda_emu"
SOURCE = ROOT.parent / "dat_segmentation_tpu_torch" / "csrc" / xb.SOURCE
NAMES = ("w3", "b3", "w7", "b7", "g", "be", "wf1", "bf1", "wd", "bd", "wf2", "bf2")
XB_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

torch.set_num_threads(2)  # as tests/torch_port_helpers.py: one of several xdist workers

# cp.async's three helpers (inline PTX in the source) and their stand-ins in
# the emulation (cuda_emu/cuda_runtime.h)
_EMULATED = (
    (r"__device__ __forceinline__ void cp_async16\(.*?\n}\n",
     "__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) "
     "{ emu_cp_async16(dst, src, valid); }\n"),
    (r"__device__ __forceinline__ void cp_async_commit\(\) \{.*?\n}\n",
     "__device__ __forceinline__ void cp_async_commit() { emu_commit(); }\n"),
    (r"template <int N> __device__ __forceinline__ void cp_async_wait\(\) \{.*?\n}\n",
     "template <int N> __device__ __forceinline__ void cp_async_wait() { emu_wait(N); }\n"),
)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The emulated K3, built once for the module."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the CPU emulation of the CUDA source")
    src = SOURCE.read_text()
    for pattern, repl in _EMULATED:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == 1, f"{pattern} not found once in {SOURCE.name}"
    assert "asm volatile" not in src, "inline PTX the emulation does not know"
    out = tmp_path_factory.mktemp("k3_emu")
    (out / "x_block_fwd_emulated.cu").write_text(src)
    exe = out / "x_block_harness"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-w", f"-I{EMU}",
         f'-DXB_SOURCE="{out / "x_block_fwd_emulated.cu"}"', "-o", str(exe),
         str(EMU / "x_block_harness.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return exe


def _inputs(dtype, B, H, W, C, k=7, mode="lpu", seed=0):
    rng = np.random.RandomState(seed)
    E = 4 * C

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.randn(*shape) * scale + shift, dtype=torch.float32).to(dtype)

    p = dict(w3=None, b3=None, w7=None, b7=None)
    if mode == "lpu":
        p.update(w3=t(C, 1, 3, 3, scale=1 / 3), b3=t(C, scale=0.1))
    if mode != "mlp":
        p.update(w7=t(C, 1, k, k, scale=1 / k), b7=t(C, scale=0.1))
    p.update(g=t(C, scale=0.1, shift=1.0), be=t(C, scale=0.1), wf1=t(E, C, scale=C ** -0.5),
             bf1=t(E, scale=0.1), wd=t(E, 1, 3, 3, scale=1 / 3), bd=t(E, scale=0.1),
             wf2=t(C, E, scale=E ** -0.5), bf2=t(C, scale=0.1))
    return t(B, H, W, C), p


def _run(exe, tmp_path, x, p, k, mode):
    B, H, W, C = x.shape
    code = {"lpu": xb.MODE_X_LPU, "x": xb.MODE_X, "mlp": xb.MODE_MLP}[mode]
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    inp, outp = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(inp, "wb") as f:
        f.write(np.array([B, H, W, C, p["wf1"].shape[0], k if mode != "mlp" else 1, code,
                          1 if x.dtype == torch.bfloat16 else 0], np.int32).tobytes())
        for a in [x] + [p[n] for n in NAMES]:
            raw = b"" if a is None else a.contiguous().view(bits).numpy().tobytes()
            f.write(np.int64(len(raw)).tobytes() + raw)
    proc = subprocess.run([str(exe), str(inp), str(outp)], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.fromfile(outp, dtype=np.int16 if bits == torch.int16 else np.int32)
    return torch.from_numpy(got.copy()).view(x.dtype).reshape(x.shape), proc.stdout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "case",
    [
        dict(B=1, H=20, W=36, C=64),  # X block with the LPU, 16-row tiles, ragged sides
        dict(B=1, H=9, W=11, C=96, mode="mlp"),  # MLP-only, half-filled 64-wide weight tiles
        dict(B=1, H=8, W=8, C=256, k=3, mode="x"),  # no LPU, window 3, 8-row tiles
        dict(B=1, H=1, W=9, C=1024, mode="mlp"),  # the widest weight stream, 2-row tiles
    ],
    ids=["lpu-c64", "mlp-c96", "x-c256-k3", "mlp-c1024"],
)
def test_emulated_kernel_matches_plain(harness, tmp_path, dtype, case):
    k, mode = case.get("k", 7), case.get("mode", "lpu")
    x, p = _inputs(dtype, **case)
    got, log = _run(harness, tmp_path, x, p, k, mode)
    ref = xb.x_block_reference(x, *(p[n] for n in NAMES), with_lpu=mode == "lpu")
    assert "rc 0" in log
    rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= XB_TOL[dtype], (rel, log)

