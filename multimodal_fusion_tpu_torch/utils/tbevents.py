"""Minimal TensorBoard event-file writer (scalars only), dependency-free
(counterpart of ``multimodal_fusion_tpu.utils.tbevents``, copied).

The reference VAE trainer writes TensorBoard scalars (``vae/train.py:84,
162-165`` via ``torch.utils.tensorboard.SummaryWriter``).  This emitter
writes the same event files with the same tags, so existing TB dashboards
keep working, without tensorboard or tensorflow installed.

Implementation: TB event files are TFRecord streams of serialized
``tensorflow.Event`` protos.  Both formats are tiny and stable, so they
are hand-encoded here:

- TFRecord framing: ``uint64 len | uint32 masked_crc32c(len) | payload |
  uint32 masked_crc32c(payload)``; the mask is
  ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff`` over CRC-32C
  (Castagnoli).
- ``Event`` proto fields used: 1 ``wall_time`` (double), 2 ``step``
  (int64), 3 ``file_version`` (string, first record only), 5 ``summary``
  (message).  ``Summary`` holds repeated ``Value`` (field 1);
  ``Summary.Value`` holds ``tag`` (field 1, string) and ``simple_value``
  (field 2, float).

Files written here load in TensorBoard unchanged (the JAX package's
``tests/test_cli_and_utils.py::test_tb_event_writer_roundtrip`` reads its
copy back with tensorboard's own ``EventFileLoader``).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from pathlib import Path

# --- CRC-32C (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire-format helpers (only what Event needs) -------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64 steps
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, value: float) -> bytes:
    return bytes([num << 3 | 1]) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return bytes([num << 3 | 5]) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return bytes([num << 3]) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return bytes([num << 3 | 2]) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _field_bytes(1, tag.encode("utf-8")) + _field_float(2, float(value))
    summary = _field_bytes(1, val)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class TBEventWriter:
    """Append-only scalar event writer, API-compatible with the subset of
    ``SummaryWriter`` the reference VAE trainer uses (``add_scalar``,
    ``flush``, ``close``)."""

    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname() or "host"
        name = f"events.out.tfevents.{time.time():.6f}.{host}.{os.getpid()}"
        self.path = self.logdir / name
        self._fh = open(self.path, "ab")
        self._lock = threading.Lock()
        self._write(_version_event(time.time()))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        rec = (
            header
            + struct.pack("<I", _masked_crc(header))
            + event
            + struct.pack("<I", _masked_crc(event))
        )
        with self._lock:
            self._fh.write(rec)

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._write(_scalar_event(tag, float(value), int(step), time.time()))

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
