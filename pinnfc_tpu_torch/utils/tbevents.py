"""Dependency-free TensorBoard scalar event files (counterpart of
``pinnfc_tpu/utils/tbevents.py``, the same record format byte for byte).

It writes ``events.out.tfevents.*`` files that TensorBoard reads natively,
without importing tensorflow or protobuf:

* **TFRecord framing**: each record is
  ``uint64le(len) · u32le(masked_crc32c(len_bytes)) · data ·
  u32le(masked_crc32c(data))``.
* **CRC32C** (Castagnoli polynomial, reflected ``0x82F63B78``) with the
  TFRecord mask ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``.
* **Event protobuf** (tensorflow/core/util/event.proto), only the fields the
  scalar dashboard needs: ``wall_time`` (field 1, double), ``step`` (field 2,
  int64), ``file_version`` (field 3, string, first record only) and
  ``summary`` (field 5) holding repeated ``Summary.Value{tag=1,
  simple_value=2}`` messages.

``read_events`` decodes such a file (CRC-verified), so tests read the files
back without TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, with the TFRecord masking scheme.
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli polynomial
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if (c & 1) else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """Plain CRC32C (RFC 3720 §B.4) of ``data``."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord-masked CRC32C (mask rotates + offsets to avoid weak CRCs)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding (only what Event/Summary need).
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


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _pb_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _pb_int64(field: int, value: int) -> bytes:
    # int64 varints encode negatives as 10-byte two's complement
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _summary_value(tag: str, simple_value: float) -> bytes:
    # Summary.Value: tag = field 1 (string), simple_value = field 2 (float)
    return _pb_bytes(1, tag.encode("utf-8")) + _pb_float(2, float(simple_value))


def _event(
    wall_time: float,
    step: Optional[int] = None,
    file_version: Optional[str] = None,
    scalars: Optional[Dict[str, float]] = None,
) -> bytes:
    buf = _pb_double(1, wall_time)
    if step is not None:
        buf += _pb_int64(2, int(step))
    if file_version is not None:
        buf += _pb_bytes(3, file_version.encode("utf-8"))
    if scalars:
        summary = b"".join(
            _pb_bytes(1, _summary_value(t, v)) for t, v in scalars.items()
        )
        buf += _pb_bytes(5, summary)
    return buf


def _tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + data
        + struct.pack("<I", masked_crc32c(data))
    )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class EventFileWriter:
    """Append scalar events to one ``events.out.tfevents.*`` file.

    Usage::

        with EventFileWriter("/tmp/tb") as w:
            w.add_scalar("loss/stage1_dnn", 0.42, step=100)

    Point TensorBoard at the directory: ``tensorboard --logdir /tmp/tb``.
    """

    _uid = 0  # per-process uniquifier (same convention as TF's writer)

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "host"
        # pid + counter: two writers in the same second (back-to-back quick
        # runs, or two writers in one process) must never collide — open
        # with 'xb' so a collision errors instead of truncating earlier data
        EventFileWriter._uid += 1
        name = (
            f"events.out.tfevents.{int(time.time())}.{host}"
            f".{os.getpid()}.{EventFileWriter._uid}{filename_suffix}"
        )
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "xb")
        # canonical first record: file_version "brain.Event:2"
        self._f.write(
            _tfrecord(_event(time.time(), file_version="brain.Event:2"))
        )

    def add_scalar(
        self, tag: str, value: float, step: int, wall_time: Optional[float] = None
    ) -> None:
        self._f.write(
            _tfrecord(
                _event(
                    time.time() if wall_time is None else wall_time,
                    step=step,
                    scalars={tag: value},
                )
            )
        )

    def add_scalars(
        self,
        scalars: Dict[str, float],
        step: int,
        wall_time: Optional[float] = None,
    ) -> None:
        """One event carrying several tags (atomic step snapshot)."""
        self._f.write(
            _tfrecord(
                _event(
                    time.time() if wall_time is None else wall_time,
                    step=step,
                    scalars=scalars,
                )
            )
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "EventFileWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Reader (for tests / offline inspection — also CRC-checks every record)
# ---------------------------------------------------------------------------


class ScalarEvent(NamedTuple):
    wall_time: float
    step: int
    tag: str
    value: float


def _iter_records(blob: bytes) -> Iterator[bytes]:
    off = 0
    n = len(blob)
    while off < n:
        if off + 12 > n:
            raise ValueError("truncated TFRecord header")
        header = blob[off : off + 8]
        (length,) = struct.unpack("<Q", header)
        (len_crc,) = struct.unpack("<I", blob[off + 8 : off + 12])
        if len_crc != masked_crc32c(header):
            raise ValueError(f"length CRC mismatch at offset {off}")
        start = off + 12
        end = start + length
        if end + 4 > n:
            raise ValueError("truncated TFRecord payload")
        data = blob[start:end]
        (data_crc,) = struct.unpack("<I", blob[end : end + 4])
        if data_crc != masked_crc32c(data):
            raise ValueError(f"data CRC mismatch at offset {off}")
        yield data
        off = end + 4


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[off]
        result |= (b & 0x7F) << shift
        off += 1
        if not (b & 0x80):
            return result, off
        shift += 7


def _pb_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, raw_payload) triples.

    Declared lengths are validated against the buffer so a malformed
    message (possible when inspecting files written by OTHER tools) raises
    a clear ValueError instead of silently truncating a tag or value."""
    off = 0
    n = len(buf)
    while off < n:
        key, off = _read_varint(buf, off)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, off = _read_varint(buf, off)
            yield field, wt, _varint(val)
        elif wt == 1:  # 64-bit
            if off + 8 > n:
                raise ValueError(f"truncated fixed64 field {field}")
            yield field, wt, buf[off : off + 8]
            off += 8
        elif wt == 5:  # 32-bit
            if off + 4 > n:
                raise ValueError(f"truncated fixed32 field {field}")
            yield field, wt, buf[off : off + 4]
            off += 4
        elif wt == 2:  # length-delimited
            ln, off = _read_varint(buf, off)
            if off + ln > n:
                raise ValueError(
                    f"length-delimited field {field} declares {ln} bytes "
                    f"but only {n - off} remain (malformed protobuf)"
                )
            yield field, wt, buf[off : off + ln]
            off += ln
        else:  # pragma: no cover - we never write groups
            raise ValueError(f"unsupported wire type {wt}")


def read_events(path: str) -> List[ScalarEvent]:
    """Decode every scalar in an event file written by this module.

    Verifies record CRCs; skips non-scalar events (e.g. file_version).
    """
    with open(path, "rb") as f:
        blob = f.read()
    out: List[ScalarEvent] = []
    for rec in _iter_records(blob):
        wall_time, step, summary = 0.0, 0, None
        for field, wt, payload in _pb_fields(rec):
            if field == 1 and wt == 1:
                (wall_time,) = struct.unpack("<d", payload)
            elif field == 2 and wt == 0:
                step, _ = _read_varint(payload, 0)
                if step >= 1 << 63:  # two's-complement negative int64
                    step -= 1 << 64
            elif field == 5 and wt == 2:
                summary = payload
        if summary is None:
            continue
        for field, wt, payload in _pb_fields(summary):
            if field != 1 or wt != 2:
                continue
            tag, value = "", None
            for vfield, vwt, vpayload in _pb_fields(payload):
                if vfield == 1 and vwt == 2:
                    tag = vpayload.decode("utf-8")
                elif vfield == 2 and vwt == 5:
                    (value,) = struct.unpack("<f", vpayload)
            if value is not None:
                out.append(ScalarEvent(wall_time, step, tag, value))
    return out
