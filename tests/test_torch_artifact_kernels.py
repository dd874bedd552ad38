"""Serving artifacts that carry their kernels' libraries, on the CPU.

No CUDA export can be made here, so the entries are a small CPU program
whose manifest ``_entry_info`` reports on the card, with K1 and K3 in its
graph, and ``ops/cuda_build.py:build`` returns a dummy library a source.
``save_artifact`` copies the libraries into ``kernels/`` and records their
digests; ``ServingModel`` takes a carried library when its digest is the
installed ``csrc/``'s (its sha256 checked, never building), never loads
one of another digest (it builds from ``csrc/``, and without nvcc raises
naming both digests), and refuses a card that is not compute capability
9.0 (``torch.cuda``'s queries monkeypatched). No plain version runs.
An artifact without the key builds as before: ``tests/test_torch_export.py``
holds that (``test_a_cuda_entry_without_nvcc_raises``).
"""

import json
import shutil
from unittest import mock

import pytest
import torch

from dat_segmentation_tpu_torch.ops import cuda_build
from dat_segmentation_tpu_torch.ops import deform_attn as da
from dat_segmentation_tpu_torch.ops import x_block as xb
from dat_segmentation_tpu_torch.serving import ServingModel, save_artifact
from dat_segmentation_tpu_torch.serving import export as serving_export

torch.set_num_threads(2)

OPS = ["dat::deform_attn_fwd", "dat::x_block_fwd"]
SOURCES = {"dat::deform_attn_fwd": da.SOURCE, "dat::x_block_fwd": xb.SOURCE}
_real_build = cuda_build.build


class _Double(torch.nn.Module):
    def forward(self, x):
        return x * 2


def _program():
    return torch.export.export(_Double(), (torch.zeros(1, 8, 8, 3),), strict=False)


@pytest.fixture
def clean_loaders(monkeypatch):
    """Empty the process's library caches and prebuilt registry, before
    and after."""
    caches = (cuda_build.load, da._library, xb._library)
    for c in caches:
        c.cache_clear()
    monkeypatch.setattr(cuda_build, "_PREBUILT", {})
    yield
    for c in caches:
        c.cache_clear()


@pytest.fixture
def artifact(tmp_path, monkeypatch, clean_loaders):
    """A one-entry artifact whose entry runs K1 and K3 on the card, saved
    with dummy libraries; returns its directory and the dummies."""
    real = serving_export._entry_info
    monkeypatch.setattr(serving_export, "_entry_info",
                        lambda p: dict(real(p), device="cuda:0", kernels=OPS))
    dummies = {}
    for op, source in SOURCES.items():
        dummies[op] = tmp_path / "build" / cuda_build.library_path(source).name
        dummies[op].parent.mkdir(exist_ok=True)
        dummies[op].write_bytes(f"a library built from {source}".encode())
    built = []

    def build(source, defines=()):
        built.append((source, defines))
        return next(d for op, d in dummies.items() if SOURCES[op] == source)

    monkeypatch.setattr(cuda_build, "build", build)
    art = save_artifact(tmp_path / "art", {"e": _program()})
    assert sorted(built) == sorted((s, ()) for s in SOURCES.values())
    monkeypatch.setattr(serving_export, "_entry_info", real)
    return art, dummies


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the loader built a kernel")

    monkeypatch.setattr(cuda_build, "build", refuse)


@pytest.fixture
def loads(monkeypatch):
    """Record the files ctypes is asked to load; hand back a stand-in."""
    paths = []

    def cdll(path):
        paths.append(path)
        return mock.MagicMock()

    monkeypatch.setattr(cuda_build.ctypes, "CDLL", cdll)
    return paths


@pytest.fixture
def card(monkeypatch):
    """``torch.cuda`` answering as one card of compute capability ``cap``."""
    state = {"cap": (9, 0), "name": "NVIDIA H100 80GB HBM3"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: state["cap"])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: state["name"])
    return state


@pytest.fixture
def no_plain(monkeypatch):
    ran = []
    monkeypatch.setattr(da, "deform_attn_reference", lambda *a, **k: ran.append("K1"))
    monkeypatch.setattr(xb, "x_block_reference", lambda *a, **k: ran.append("K3"))
    return ran


def test_save_artifact_carries_the_libraries(artifact):
    art, dummies = artifact
    meta = json.loads((art / "meta.json").read_text())
    assert meta["format_version"] == 1
    libs = meta["kernel_libraries"]
    assert [lib["op"] for lib in libs] == OPS
    for lib in libs:
        op = lib["op"]
        assert (art / lib["file"]).read_bytes() == dummies[op].read_bytes()
        assert lib["file"] == f"kernels/{dummies[op].name}"
        assert lib["source"] == SOURCES[op] and lib["defines"] == []
        assert lib["digest"] == cuda_build.digest(SOURCES[op])
        assert lib["digest"] in cuda_build.library_path(SOURCES[op]).name
        assert lib["sha256"] == cuda_build.file_sha256(dummies[op])
        assert lib["arch"] == "sm_90a" and lib["bytes"] == dummies[op].stat().st_size


def test_a_cpu_entry_carries_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "build", lambda *a, **k: pytest.fail("built a library"))
    art = save_artifact(tmp_path / "art", {"e": _program()})
    assert "kernel_libraries" not in json.loads((art / "meta.json").read_text())
    assert not (art / "kernels").exists()


def test_the_loader_takes_the_carried_libraries(artifact, no_build, loads, card):
    art, _ = artifact
    srv = ServingModel.load(art)
    srv._load_kernels("e")
    libs = srv.meta["kernel_libraries"]
    assert loads == [str(art / lib["file"]) for lib in libs]


def test_a_carried_library_is_checked_against_its_sha256(artifact, no_build, loads, card):
    art, _ = artifact
    lib = json.loads((art / "meta.json").read_text())["kernel_libraries"][0]
    (art / lib["file"]).write_bytes(b"something else")
    with pytest.raises(RuntimeError, match=rf"{lib['op']}.*sha256.*{lib['sha256']}"):
        ServingModel.load(art)._load_kernels("e")
    assert loads == []


def test_a_library_of_another_digest_is_never_loaded(artifact, loads, no_plain, tmp_path,
                                                     monkeypatch):
    """Its C interface may have changed: the loader builds from csrc/
    instead, and without nvcc that raises, naming the op and both digests."""
    art, _ = artifact
    meta = json.loads((art / "meta.json").read_text())
    stale = meta["kernel_libraries"][0]
    stale["digest"] = "0123456789abcdef"
    (art / "meta.json").write_text(json.dumps(meta))
    monkeypatch.setattr(cuda_build, "build", _real_build)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    installed = cuda_build.digest(stale["source"])
    with pytest.raises(RuntimeError, match=rf"{stale['op']}.*0123456789abcdef.*{installed}.*nvcc"):
        ServingModel.load(art)("e", torch.zeros(1, 8, 8, 3))
    assert loads == [] and no_plain == []


def test_a_card_other_than_hopper_is_refused(artifact, no_build, loads, card, no_plain):
    art, _ = artifact
    card.update(cap=(8, 0), name="NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match=r"NVIDIA A100-SXM4-80GB is compute capability 8\.0.*"
                                           r"sm_90a"):
        ServingModel.load(art)("e", torch.zeros(1, 8, 8, 3))
    assert loads == [] and no_plain == []


def test_the_digest_covers_source_headers_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    base = cuda_build.digest(da.SOURCE)
    assert len(base) == 16 and base == cuda_build.digest(da.SOURCE, ())
    assert cuda_build.digest(da.SOURCE, ("K1_NO_BIAS",)) != base
    with (csrc / "fragments.cuh").open("a") as f:
        f.write("\n")
    assert cuda_build.digest(da.SOURCE) != base
