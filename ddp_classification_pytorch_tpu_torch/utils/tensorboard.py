"""Dependency-free TensorBoard scalar writer.

The port's copy of the JAX package's `utils/tensorboard.py` (the port
imports nothing of the JAX package). The reference carries tensorboardX
imports but keeps them commented out
(BASELINE/main.py:41-42,311; ARCFACE/arc_main.py:52-53) — observability it
never shipped (SURVEY §5 metrics row). This module writes real TensorBoard
event files with ZERO dependencies by emitting the two stable on-disk formats
directly:

- TFRecord framing: {uint64 length, masked-crc32c(length), payload,
  masked-crc32c(payload)} per record;
- the tiny protobuf subset TensorBoard's scalar dashboard reads
  (tensorflow.Event{wall_time, step, file_version | summary} and
  Summary.Value{tag, simple_value}), hand-encoded on the protobuf wire
  format.

`tensorboard --logdir <out_dir>/tb` renders the result. Scalars only — that
is the whole surface the reference's commented-out usage touched (loss and
accuracy curves).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Iterator, Optional, Tuple

# ------------------------------------------------------------------ crc32c --

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------- protobuf wire encoding --


def _varint(n: int) -> bytes:
    if n < 0:  # protobuf int64: two's complement, 10-byte encoding
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _event(wall_time: float, step: int, *,
           file_version: Optional[str] = None,
           tag: Optional[str] = None,
           value: Optional[float] = None) -> bytes:
    # tensorflow.Event: 1=wall_time(double) 2=step(int64) 3=file_version(str)
    # 5=summary(Summary); Summary: 1=repeated Value; Value: 1=tag(str)
    # 2=simple_value(float)
    ev = _field_double(1, wall_time) + _field_varint(2, step)
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if tag is not None:
        val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
        ev += _field_bytes(5, _field_bytes(1, val))
    return ev


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


# ------------------------------------------------------------------ writer --


class SummaryWriter:
    """Minimal `add_scalar`/`flush`/`close` writer, tensorboard-compatible."""

    def __init__(self, logdir: str, run_name: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{run_name or 'run'}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._f.write(_record(_event(time.time(), 0,
                                     file_version="brain.Event:2")))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._f.write(_record(_event(
            wall_time if wall_time is not None else time.time(),
            int(step), tag=tag, value=float(value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# -------------------------------------------------------------- reader ------
# Inverse of the writer — used by tests to round-trip files, and handy for
# loading curves back into notebooks without a tensorboard install.


def read_scalars(path: str) -> Iterator[Tuple[int, str, float]]:
    """Yield (step, tag, value) from an event file, verifying every CRC."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if hcrc != _masked_crc(header):
            raise ValueError(f"corrupt record header at byte {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if pcrc != _masked_crc(payload):
            raise ValueError(f"corrupt record payload at byte {pos}")
        pos += 16 + length
        yield from _decode_event(payload)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
            yield num, wire, val
        elif wire == 1:
            yield num, wire, buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            yield num, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:
            yield num, wire, buf[i:i + 4]
            i += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")


def _decode_event(payload: bytes) -> Iterator[Tuple[int, str, float]]:
    step = 0
    summaries = []
    for num, wire, val in _fields(payload):
        if num == 2 and wire == 0:
            step = int(val)
            if step >= 1 << 63:  # int64 two's complement
                step -= 1 << 64
        elif num == 5 and wire == 2:
            summaries.append(val)
    for summary in summaries:
        for num, wire, val in _fields(summary):
            if num == 1 and wire == 2:  # Summary.Value
                tag, simple = "", None
                for n2, w2, v2 in _fields(val):
                    if n2 == 1 and w2 == 2:
                        tag = v2.decode()
                    elif n2 == 2 and w2 == 5:
                        (simple,) = struct.unpack("<f", v2)
                if simple is not None:
                    yield step, tag, simple
