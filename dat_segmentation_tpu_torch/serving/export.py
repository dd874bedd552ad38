"""Serving export: ``torch.export`` artifacts and a loader without model code.

Counterpart of ``dat_segmentation_tpu/serving/export.py``, with its names
and contract. An artifact is a directory: one ``<name>.pt2`` a static input
shape (``torch.export.save`` of the forward, weights included) and
``meta.json``, the input/output contract (shapes and dtypes per entry,
normalisation constants, class names and palette, output stride). A
serving host loads it with ``ServingModel``, which imports only the op
modules of the port's kernels (``ops/deform_attn.py``, ``ops/x_block.py``),
never the model code (``models/``).

* The segmentor's entry is the stride-4-logits forward (``upsample=False``),
  as ``SegInferencer.forward_batch`` runs it: the final bilinear upsample is
  linear, so it runs after slicing off the padding (``predict_semseg``).
* The graph holds the hand-written kernels as the ops ``dat::deform_attn_fwd``
  (K1, in every entry) and ``dat::x_block_fwd`` (K3, with ``portable=False``
  on a ``kernel_impl='pallas'`` config). ``portable=True``, the default as
  in the JAX package, sets ``kernel_impl='xla'``: the unfused chain in place
  of K3. The port has no route without K1.
* Shapes are static, one entry per (batch, H, W). ``torch.export`` bakes
  devices into the graph (the model makes tensors on its input's device), so
  an entry is exported on the device it will run on, which ``meta.json``
  records; the JAX ``platforms`` argument becomes ``device``.
* An artifact with a CUDA entry carries its kernels' ``sm_90a`` libraries
  in ``kernels/``, one for each ``dat::`` op its CUDA entries call, and
  ``meta.json`` records each under ``kernel_libraries`` (op, file, source,
  defines, the digest ``ops/cuda_build.py`` keys a build by, sha256, arch).
  ``ServingModel`` loads a carried library, checking its sha256, when its
  digest is the one the installed ``csrc/`` gives, and then never calls
  ``nvcc``. A library of another digest is never loaded (its C interface
  may differ): the kernel is built from ``csrc/`` as for an artifact
  without the key, and on a host without ``nvcc`` that raises, naming the
  kernel and both digests. A card that is not compute capability 9.0 is
  refused before any load. The loader never runs a kernel's plain version
  on the card. CPU entries carry no library.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..ops import cuda_build
from ..ops import deform_attn as _k1  # registers dat::deform_attn_fwd
from ..ops import x_block as _k3  # registers dat::x_block_fwd
from ..ops.interpolate import resize_bilinear

_FORMAT_VERSION = 1
# each op's CUDA source (built without defines) and the loader of its library
_KERNELS = {"dat::deform_attn_fwd": (_k1.SOURCE, _k1._library),
            "dat::x_block_fwd": (_k3.SOURCE, _k3._library)}


def _portable_cfg(model_cfg, portable: bool):
    if not portable:
        return model_cfg
    return dataclasses.replace(
        model_cfg, backbone=dataclasses.replace(model_cfg.backbone, kernel_impl="xla"))


class _Forward(nn.Module):
    """(B, H, W, 3) float32 -> the model's float32 output, in ``dtype``."""

    def __init__(self, model: nn.Module, dtype: torch.dtype, **kwargs):
        super().__init__()
        self.model, self.dtype, self.kwargs = model, dtype, kwargs

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.model(image.to(self.dtype), **self.kwargs).float()


def _export(model_cfg, state, *, batch, input_size, compute_dtype, device, portable, **kwargs):
    from ..models.builder import build_model
    from ..utils.device import resolve_device

    device = resolve_device(device)
    model = build_model(_portable_cfg(model_cfg, portable), device=device)
    model.load_state_dict(state)
    model = model.to(dtype=compute_dtype).eval().requires_grad_(False)
    h, w = input_size
    example = torch.zeros(batch, h, w, 3, device=device)
    program = torch.export.export(_Forward(model, compute_dtype, **kwargs), (example,),
                                  strict=False)
    program.example_inputs = None  # else saved with the artifact: a batch of zeros
    return program


def export_segmentor(
    model_cfg,
    state: Dict[str, torch.Tensor],
    *,
    batch: int = 1,
    input_size: Tuple[int, int] = (512, 512),
    compute_dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
    portable: bool = True,
) -> torch.export.ExportedProgram:
    """Export the segmentor forward: (B, H, W, 3) normalised float32 ->
    (B, H/4, W/4, num_classes) float32 stride-4 logits.

    ``state`` is the segmentor's ``state_dict`` (loaded strictly into a
    model built from ``model_cfg``, cast to ``compute_dtype`` with its
    parameters frozen, so that the graph holds the kernels' no-grad ops).
    ``device`` defaults to the card. Returns the ``ExportedProgram``.
    """
    return _export(model_cfg, state, batch=batch, input_size=input_size,
                   compute_dtype=compute_dtype, device=device, portable=portable,
                   upsample=False)


def export_classifier(
    model_cfg,
    state: Dict[str, torch.Tensor],
    *,
    batch: int = 1,
    input_size: Tuple[int, int] = (224, 224),
    compute_dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
    portable: bool = True,
) -> torch.export.ExportedProgram:
    """Export the classifier forward: (B, H, W, 3) float32 -> (B, num_classes)
    float32 logits. Arguments as in ``export_segmentor``."""
    return _export(model_cfg, state, batch=batch, input_size=input_size,
                   compute_dtype=compute_dtype, device=device, portable=portable)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _entry_info(program: torch.export.ExportedProgram) -> Dict[str, Any]:
    """The contract of one exported entry: input and output shape and
    dtype, its device and the ``dat::`` ops (kernels) its graph calls."""
    user_inputs = set(program.graph_signature.user_inputs)
    nodes = list(program.graph.nodes)
    inp = next(n for n in nodes if n.op == "placeholder" and n.name in user_inputs).meta["val"]
    out = next(n for n in nodes if n.op == "output").args[0][0].meta["val"]
    kernels = sorted({n.target._schema.name for n in nodes if n.op == "call_function"
                      and getattr(n.target, "namespace", None) == "dat"})
    return {
        "input_shape": list(inp.shape),
        "input_dtype": _dtype_name(inp.dtype),
        "output_shape": list(out.shape),
        "output_dtype": _dtype_name(out.dtype),
        "device": str(inp.device),
        "kernels": kernels,
    }


def _carry_kernels(directory: Path, ops) -> list:
    """Build each op's library (or take the one ``_build/`` holds), copy it
    into ``<directory>/kernels/`` and return the manifest's records."""
    (directory / "kernels").mkdir(exist_ok=True)
    records = []
    for op in ops:
        source = _KERNELS[op][0]
        built = cuda_build.build(source)
        dst = directory / "kernels" / built.name
        shutil.copyfile(built, dst)
        records.append({"op": op, "file": f"kernels/{dst.name}", "source": source,
                        "defines": [], "digest": cuda_build.digest(source),
                        "sha256": cuda_build.file_sha256(dst), "arch": cuda_build.ARCH,
                        "bytes": dst.stat().st_size})
    return records


def save_artifact(
    directory,
    entries: Dict[str, torch.export.ExportedProgram],
    *,
    task: str = "segmentor",
    model_cfg=None,
    num_classes: Optional[int] = None,
    classes: Optional[Sequence[str]] = None,
    palette: Optional[Sequence[Sequence[int]]] = None,
    extra_meta: Optional[dict] = None,
) -> Path:
    """Write ``{name: ExportedProgram}`` as ``<dir>/<name>.pt2`` plus a
    ``meta.json`` manifest (the JAX manifest's keys; ``device`` for
    ``platforms``, ``torch_version`` for ``jax_version``), and the kernel
    libraries of the CUDA entries under ``kernels/`` (built with ``nvcc``
    where ``_build/`` lacks them)."""
    from ..data.ade20k import IMG_NORM_MEAN, IMG_NORM_STD

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest_entries = {}
    for name, program in entries.items():
        path = directory / f"{name}.pt2"
        torch.export.save(program, path)
        manifest_entries[name] = {"file": path.name, **_entry_info(program),
                                  "bytes": path.stat().st_size}
    meta = {
        "format_version": _FORMAT_VERSION,
        "task": task,
        "torch_version": torch.__version__,
        "entries": manifest_entries,
        "output_stride": 4 if task == "segmentor" else None,
        "norm_mean": [float(v) for v in IMG_NORM_MEAN],
        "norm_std": [float(v) for v in IMG_NORM_STD],
    }
    cuda_ops = sorted({op for info in manifest_entries.values()
                       if torch.device(info["device"]).type == "cuda" for op in info["kernels"]})
    if cuda_ops:
        meta["kernel_libraries"] = _carry_kernels(directory, cuda_ops)
    if num_classes is not None:
        meta["num_classes"] = int(num_classes)
    if classes is not None:
        meta["classes"] = list(classes)
    if palette is not None:
        meta["palette"] = [list(p) for p in palette]
    if model_cfg is not None:
        meta["model_config"] = dataclasses.asdict(model_cfg)
    if extra_meta:
        meta.update(extra_meta)
    (directory / "meta.json").write_text(json.dumps(meta, default=str))
    return directory


class ServingModel:
    """Load an exported artifact directory and serve predictions.

    Needs torch, numpy and the port's op modules, not the model code.
    Entries load on first call and are cached by name; each runs on the
    device it was exported for. A CUDA entry loads its kernels' libraries
    first (``_load_kernels``).
    """

    def __init__(self, directory):
        self.directory = Path(directory)
        self.meta = json.loads((self.directory / "meta.json").read_text())
        if self.meta.get("format_version", 0) > _FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.meta['format_version']} is newer "
                f"than this loader ({_FORMAT_VERSION})"
            )
        self._fns: Dict[str, Any] = {}

    @classmethod
    def load(cls, directory) -> "ServingModel":
        return cls(directory)

    @property
    def entries(self) -> Dict[str, dict]:
        return self.meta["entries"]

    def _device(self, name: str) -> torch.device:
        return torch.device(self.entries[name]["device"])

    def _load_kernels(self, name: str) -> None:
        """Load the libraries of a CUDA entry's kernels: the artifact's own
        where its digest is the installed ``csrc/``'s, else built from
        ``csrc/`` by nvcc. Raises on a card other than compute capability
        9.0 and on any library that does not load."""
        if torch.cuda.is_available():
            cuda_build.check_card(self._device(name))
        carried = {lib["op"]: lib for lib in self.meta.get("kernel_libraries", [])}
        for op in self.entries[name]["kernels"]:
            source, loader = _KERNELS[op]
            how = "built from the package's csrc/ by nvcc at first use"
            lib = carried.get(op)
            if lib is not None:
                installed = cuda_build.digest(source)
                if lib["digest"] == installed:
                    cuda_build.use_prebuilt(source, (), self.directory / lib["file"],
                                            lib["sha256"])
                    how = f"the artifact's {lib['file']}"
                else:
                    how = (f"built from the package's csrc/ by nvcc: the artifact's library has "
                           f"digest {lib['digest']}, the installed csrc/ gives {installed}")
            try:
                loader()
            except (OSError, RuntimeError) as e:
                raise RuntimeError(f"entry {name} runs the kernel {op} on the card; its "
                                   f"library is {how}: {e}") from e

    def _fn(self, name: str):
        if name not in self._fns:
            if self._device(name).type == "cuda":
                self._load_kernels(name)
            file = self.directory / self.entries[name]["file"]
            self._fns[name] = torch.export.load(file).module()
        return self._fns[name]

    def __call__(self, name: str, image) -> torch.Tensor:
        """Raw entry call: normalised float32 input at the entry's exact
        shape -> its float32 output, on the entry's device."""
        fn = self._fn(name)
        x = torch.as_tensor(image).to(self._device(name), torch.float32)
        with torch.inference_mode():
            return fn(x)

    # -- convenience serving paths ------------------------------------------

    def _pick_entry(self, h: int, w: int) -> str:
        """Smallest entry that fits (h, w); error if none does."""
        best = None
        for name, info in self.entries.items():
            _, eh, ew, _ = info["input_shape"]
            if eh >= h and ew >= w:
                area = eh * ew
                if best is None or area < best[0]:
                    best = (area, name)
        if best is None:
            raise ValueError(
                f"no exported entry fits input {h}x{w}; have "
                f"{[tuple(i['input_shape'][1:3]) for i in self.entries.values()]}"
            )
        return best[1]

    def predict_semseg(self, raw_img: np.ndarray, entry: Optional[str] = None) -> np.ndarray:
        """(H, W, 3) uint8 RGB -> (H, W) int32 class map.

        Normalises, zero-pads to the entry shape (smallest fitting entry
        by default), forwards, upsamples the stride-4 logits to the entry
        shape (bilinear, half-pixel centres) and slices the image region
        off, all on the entry's device, as the JAX ``predict_semseg``.
        """
        if self.meta["task"] != "segmentor":
            raise ValueError(f"predict_semseg on a {self.meta['task']} artifact")
        h, w = raw_img.shape[:2]
        entry = entry or self._pick_entry(h, w)
        b, eh, ew, _ = self.entries[entry]["input_shape"]
        device = self._device(entry)
        mean = torch.tensor(self.meta["norm_mean"], dtype=torch.float32, device=device)
        std = torch.tensor(self.meta["norm_std"], dtype=torch.float32, device=device)
        img = torch.as_tensor(np.ascontiguousarray(raw_img)).to(device, torch.float32)
        padded = torch.zeros(b, eh, ew, 3, device=device)
        padded[0, :h, :w] = (img - mean) / std
        small = self(entry, padded)[:1]  # (1, eh/4, ew/4, C)
        logits = resize_bilinear(small, (eh, ew))[0, :h, :w]
        return logits.argmax(-1).to(torch.int32).cpu().numpy()

    def predict_cls(self, image: np.ndarray, entry: Optional[str] = None):
        """Normalised (H, W, 3) or (B, H, W, 3) float32 -> (B,) int32 argmax
        and (B, num_classes) float32 logits, on the host."""
        if self.meta["task"] != "classifier":
            raise ValueError(f"predict_cls on a {self.meta['task']} artifact")
        if image.ndim == 3:
            image = image[None]
        entry = entry or next(iter(self.entries))
        logits = self(entry, np.asarray(image, np.float32)).cpu().numpy()
        return np.argmax(logits, axis=-1).astype(np.int32), logits
