"""Image decoding for the ADE20K pipeline without cv2.

The JAX package decodes with ``cv2.imread`` (``data/ade20k.py:348-356``
there). The port does not depend on cv2; it reads:

* JPEG through Pillow (``Image.open(p).convert("RGB")``, the EXIF
  orientation applied as ``cv2.imread`` applies it). Pillow and cv2 both
  decode with libjpeg-turbo's defaults (integer slow DCT, fancy
  upsampling); ``tests/data/ade20k_tiny/decode`` holds cv2's decodes that
  the card's is held to. Without Pillow the read raises: the port wires
  no other decoder (nvJPEG, in the CUDA toolkit, would be the next one).
* PNG through its own reader on the standard library's ``zlib``: 8-bit
  greyscale, non-interlaced, all five row filters, which is what an
  ADE20K annotation is. Any other kind raises, naming it; nothing is
  converted silently. The reader is exact by construction.

``write_png`` writes the test CLI's class maps (8-bit greyscale or RGB,
unfiltered rows, ``zlib``), which cv2 reads back unchanged.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

PathLike = Union[str, Path]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale + alpha", 6: "RGBA"}


def imread_rgb(path: PathLike) -> np.ndarray:
    """(H, W, 3) uint8 RGB: ``cv2.imread(path, IMREAD_COLOR)`` then
    ``BGR2RGB``. A greyscale image is replicated to three channels."""
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(
            f"decoding {path} needs Pillow (PIL), the port's JPEG decoder; "
            "no other decoder (nvJPEG) is wired"
        ) from e
    with Image.open(path) as im:
        return np.array(ImageOps.exif_transpose(im).convert("RGB"), dtype=np.uint8)


def imread_gray(path: PathLike) -> np.ndarray:
    """(H, W) uint8: ``cv2.imread(path, IMREAD_GRAYSCALE)`` of an 8-bit
    greyscale PNG (an annotation)."""
    return read_png_gray8(Path(path).read_bytes(), str(path))


def _chunks(data: bytes, where: str):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{where}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{where}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{where}: PNG without IEND")


def read_png_gray8(data: bytes, where: str = "<bytes>") -> np.ndarray:
    """Decode an 8-bit greyscale non-interlaced PNG to (H, W) uint8."""
    if data[: len(_PNG_SIGNATURE)] != _PNG_SIGNATURE:
        raise ValueError(f"{where}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, where):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{where}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if colour != 0 or depth != 8 or interlace != 0:
        kind = _COLOUR_TYPES.get(colour, f"colour type {colour}")
        raise ValueError(
            f"{where}: a {depth}-bit {kind}{' Adam7-interlaced' if interlace else ''} PNG; "
            "the reader takes 8-bit greyscale, non-interlaced (an annotation)"
        )
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w + 1):
        raise ValueError(f"{where}: {len(raw)} bytes of image data, want {h * (w + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    return _unfilter(rows[:, 0], rows[:, 1:])


def _unfilter(filters: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of one byte a pixel (PNG spec, section 9).

    None and Up are whole-row numpy ops, Sub a running sum mod 256; Average
    and Paeth depend on the pixel to the left through a floor or a choice,
    so they run a byte at a time."""
    h, w = rows.shape
    out = np.empty((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        f, row = int(filters[y]), rows[y]
        if f == 0:
            cur = row
        elif f == 1:
            cur = np.cumsum(row, dtype=np.uint8)
        elif f == 2:
            cur = row + prev
        elif f == 3:
            cur = _average(row.tolist(), prev.tolist())
        elif f == 4:
            cur = _paeth(row.tolist(), prev.tolist())
        else:
            raise ValueError(f"PNG row {y}: filter type {f} (0-4 are defined)")
        out[y] = cur
        prev = out[y]
    return out


def _average(row, up):
    left, cur = 0, bytearray(len(row))
    for x, (r, b) in enumerate(zip(row, up)):
        left = (r + ((left + b) >> 1)) & 255
        cur[x] = left
    return np.frombuffer(cur, np.uint8)


def _paeth(row, up):
    a = c = 0
    cur = bytearray(len(row))
    for x, (r, b) in enumerate(zip(row, up)):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a = (r + pred) & 255
        cur[x] = a
        c = b
    return np.frombuffer(cur, np.uint8)


def write_png(path: PathLike, img: np.ndarray) -> Path:
    """Write (H, W) uint8 as an 8-bit greyscale PNG, or (H, W, 3) uint8 as
    8-bit RGB (channels in RGB order; ``cv2.imread`` gives them back as
    BGR). Rows unfiltered, deflated by ``zlib``; lossless."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if img.ndim == 3 else 0, 0, 0, 0)
    path = Path(path)
    path.write_bytes(_PNG_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))
    return path
