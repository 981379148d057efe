"""Minimal, dependency-free TensorBoard event writer.

A copy of `audio_classification_icbhi_tpu/utils/tensorboard.py`: hand-encoded
protobuf Event/Summary messages in TFRecord framing with masked CRC32C, so
the port writes standard `events.out.tfevents.*` files without tensorboard
or tensorflow installed.

Same tag names as the JAX trainer: Loss/train, Loss/val, Accuracy/train,
Accuracy/val, Learning_Rate, ICBHI/{score,sensitivity,specificity}.
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path

# --- CRC32C (Castagnoli), table-driven ---------------------------------------

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
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire helpers ----------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        # protobuf int64: negatives are 10-byte two's complement (a bare
        # arithmetic right-shift loop never terminates on n < 0)
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, p: int) -> tuple[int, int]:
    """Decode a varint at buf[p:]; returns (value, next_pos). The writer
    emits multi-byte varints for any length/step >= 128, so the reader must
    decode them the same way (single-byte reads mis-parse tags >= ~121
    chars and large steps)."""
    val = 0
    shift = 0
    while buf[p] & 0x80:
        val |= (buf[p] & 0x7F) << shift
        shift += 7
        p += 1
    val |= buf[p] << shift
    return val, p + 1


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_msg = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary_msg = _field_bytes(1, value_msg)
    return _field_double(1, wall_time) + _field_varint(2, int(step)) + _field_bytes(5, summary_msg)


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class SummaryWriter:
    """Drop-in (scalar-only) analog of torch.utils.tensorboard.SummaryWriter."""

    def __init__(self, log_dir: str | Path = "runs"):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(self.log_dir / fname, "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        self._write_record(_scalar_event(tag, value, global_step, time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalars(event_file: str | Path) -> dict[str, list[tuple[int, float]]]:
    """Parse scalar events back out of an event file (used by the
    confusion-matrix-from-runs tooling, reference
    generate_confusion_matrix.py:23-59, and by tests)."""
    raw = Path(event_file).read_bytes()
    pos = 0
    out: dict[str, list[tuple[int, float]]] = {}
    while pos + 12 <= len(raw):
        (length,) = struct.unpack_from("<Q", raw, pos)
        payload = raw[pos + 12 : pos + 12 + length]
        pos += 12 + length + 4
        step, summary = 0, None
        p = 0
        while p < len(payload):
            key = payload[p]
            if key == 0x09:  # wall_time double
                p += 9
            elif key == 0x10:  # step varint
                step, p = _read_varint(payload, p + 1)
                if step >= 1 << 63:  # protobuf int64 two's complement
                    step -= 1 << 64
            elif key in (0x1A, 0x2A):  # file_version / summary
                ln, p = _read_varint(payload, p + 1)
                if key == 0x2A:
                    summary = payload[p : p + ln]
                p += ln
            else:
                break
        if summary:
            q = 0
            while q < len(summary):
                if summary[q] != 0x0A:
                    break
                vlen, q = _read_varint(summary, q + 1)
                vmsg = summary[q : q + vlen]
                q += vlen
                tag, val = None, None
                r = 0
                while r < len(vmsg):
                    if vmsg[r] == 0x0A:
                        tlen, r = _read_varint(vmsg, r + 1)
                        tag = vmsg[r : r + tlen].decode()
                        r += tlen
                    elif vmsg[r] == 0x15:
                        (val,) = struct.unpack_from("<f", vmsg, r + 1)
                        r += 5
                    else:
                        break
                if tag is not None and val is not None:
                    out.setdefault(tag, []).append((step, val))
    return out
