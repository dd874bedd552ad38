"""Pure-python TensorBoard scalar event writer: no TF or tensorboardX.

A copy of ``dat_segmentation_tpu/utils/tensorboard.py`` (pure Python; the
port keeps its own so that it imports nothing of the JAX package). The
reference tensorboards training scalars through
``torch.utils.tensorboard.SummaryWriter``; this module writes the same
on-disk artifact, a TFRecord stream of ``tensorflow.Event`` protos, with the
record framing (length + masked CRC32C) and the two protos hand-encoded:

  Event { 1: double wall_time; 2: int64 step;
          3: string file_version; 5: Summary summary }
  Summary { 1: repeated Value { 1: string tag; 2: float simple_value } }

``tensorboard --logdir <dir>`` reads these directly. Scalars are low-rate
(one record per log interval), so the pure-python CRC costs nothing.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path


def _crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, *, file_version: str = "",
           summary: bytes = b"") -> bytes:
    body = bytes([0x09]) + struct.pack("<d", wall_time)  # 1: wall_time
    if step:
        body += bytes([0x10]) + _varint(step)  # 2: step (varint)
    if file_version:
        body += _field_bytes(3, file_version.encode())
    if summary:
        body += _field_bytes(5, summary)
    return body


def _scalar_summary(values: dict) -> bytes:
    out = b""
    for tag, val in values.items():
        v = _field_bytes(1, str(tag).encode())  # Value.tag
        v += bytes([0x15]) + struct.pack("<f", float(val))  # Value.simple_value
        out += _field_bytes(1, v)  # Summary.value (repeated)
    return out


class SummaryWriter:
    """Minimal scalar-only TB writer (torch SummaryWriter API subset)."""

    def __init__(self, logdir: str):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname()
        name = f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
        self._f = (self.logdir / name).open("ab")
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value, step: int):
        self.add_scalars_dict({tag: value}, step)

    def add_scalars_dict(self, values: dict, step: int):
        """One Event carrying every (tag, value) pair — one record per
        log interval instead of one per scalar."""
        self._write_record(
            _event(time.time(), int(step), summary=_scalar_summary(values))
        )
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        try:
            self._f.close()
        except Exception:  # noqa: BLE001
            pass
