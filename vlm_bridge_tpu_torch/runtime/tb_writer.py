"""Minimal TensorBoard event-file writer and reader, pure Python (the port's
own copy of vlm_bridge_tpu.runtime.tb_writer; tests/test_torch_port.py holds
its output equal to that module's byte for byte).

Writes standard `events.out.tfevents.*` files readable by TensorBoard:
TFRecord framing (length + masked CRC32C) around hand-encoded protobuf
`Event` messages (scalars via simple_value, text via string TensorProto with
the "text" plugin). No `tensorboard` import: `read_scalars` / `read_events`
are how a run checks its own log where that package is absent.

Metric-name parity: callers use the reference's tags (train/loss,
train/learning_rate, train/grad_norm_before_clip, epoch/train_loss,
val/loss, val/perplexity, ...) so existing dashboards keep working.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-based
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format encoding (just what Event/Summary need)
# ---------------------------------------------------------------------------


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


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(step: int, tag: str, value: float, wall_time: float) -> bytes:
    value_msg = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    summary = _f_bytes(1, value_msg)
    return (_f_double(1, wall_time) + _f_varint(2, step) + _f_bytes(5, summary))


def _text_event(step: int, tag: str, text: str, wall_time: float) -> bytes:
    # TensorProto: dtype=DT_STRING(7) [f1], tensor_shape [f2: dim{size=1}],
    # string_val [f8]
    dim = _f_varint(1, 1)  # TensorShapeProto.Dim.size = 1
    shape = _f_bytes(2, dim)
    tensor = _f_varint(1, 7) + _f_bytes(2, shape) + _f_bytes(8, text.encode())
    # SummaryMetadata.PluginData.plugin_name = "text"
    plugin = _f_bytes(1, b"text")
    metadata = _f_bytes(1, plugin)
    value_msg = (
        _f_bytes(1, (tag + "/text_summary").encode())
        + _f_bytes(9, metadata) + _f_bytes(8, tensor))
    summary = _f_bytes(1, value_msg)
    return (_f_double(1, wall_time) + _f_varint(2, step) + _f_bytes(5, summary))


class SummaryWriter:
    """Drop-in minimal replacement for torch.utils.tensorboard.SummaryWriter
    (scalars + text)."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self._f = open(self.log_dir / fname, "ab")
        self._write_record(
            _f_double(1, time.time()) + _f_bytes(3, b"brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(
            _scalar_event(step, tag, value, wall_time or time.time()))

    def add_text(self, tag: str, text: str, step: int,
                 wall_time: Optional[float] = None) -> None:
        self._write_record(
            _text_event(step, tag, text, wall_time or time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class NullWriter:
    """No-op writer for non-zero processes in multi-host runs."""

    def add_scalar(self, *a, **k) -> None:
        pass

    def add_text(self, *a, **k) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _parse_fields(buf: bytes):
    """Decode one protobuf message level: yields (field, wire, value)."""
    i = 0
    n = len(buf)
    while i < n:
        key = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, v
        elif wire == 1:  # 64-bit
            yield field, wire, struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        elif wire == 5:  # 32-bit
            yield field, wire, struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, buf[i:i + ln]
            i += ln
        else:  # pragma: no cover - never written by this module
            raise ValueError(f"unsupported wire type {wire}")


def read_scalars(path: str | Path):
    """Decode scalar events back out of an event file written by this module.

    Returns {tag: [(step, value), ...]} — the inverse of add_scalar; used by
    tests and by runs that check their own log.
    """
    out: dict = {}
    for payload in read_events(path):
        step = 0
        summary = None
        for field, wire, v in _parse_fields(payload):
            if field == 2 and wire == 0:
                step = v
            elif field == 5 and wire == 2:
                summary = v
        if summary is None:
            continue
        for field, wire, v in _parse_fields(summary):
            if field == 1 and wire == 2:
                tag, value = None, None
                for f2, w2, v2 in _parse_fields(v):
                    if f2 == 1 and w2 == 2:
                        tag = v2.decode()
                    elif f2 == 2 and w2 == 5:
                        value = v2
                if tag is not None and value is not None:
                    out.setdefault(tag, []).append((step, value))
    return out


def read_events(path: str | Path):
    """Tiny TFRecord reader for tests: yields raw event payload bytes."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (crc_h,) = struct.unpack("<I", f.read(4))
            assert crc_h == _masked_crc(header), "corrupt header crc"
            payload = f.read(length)
            (crc_p,) = struct.unpack("<I", f.read(4))
            assert crc_p == _masked_crc(payload), "corrupt payload crc"
            yield payload
