"""Typed memcomparable value/row serialization (port of
dingo_tpu/common/serial.py).

Reference: the dingo-serial submodule (src/serial/) provides schema-typed
memcomparable row/key encoding so table keys sort correctly in the KV space;
SURVEY.md §2.4 requires the *behavior* (order-preserving typed encoding).
Original implementation: tagged, order-preserving encodings for null / bool /
int64 / float64 / string, composable into multi-column keys.

Ordering rules:
  null < bool < int < float < string   (type tag orders first)
  int64:  offset-binary (x ^ sign bit) big-endian
  float64: IEEE754 with sign-dependent bit flip (standard memcomparable trick)
  string: memcomparable byte groups (mvcc codec scheme)
"""

from __future__ import annotations

import struct
from typing import Any, List, Sequence, Tuple

from dingo_tpu_torch.mvcc.codec import Codec

_TAG_NULL = 0x01
_TAG_BOOL = 0x02
_TAG_INT = 0x03
_TAG_FLOAT = 0x04
_TAG_STR = 0x05


def encode_value(v: Any) -> bytes:
    if v is None:
        return bytes([_TAG_NULL])
    if isinstance(v, bool):
        return bytes([_TAG_BOOL, 1 if v else 0])
    if isinstance(v, int):
        return bytes([_TAG_INT]) + struct.pack(">Q", (v + (1 << 63)) & ((1 << 64) - 1))
    if isinstance(v, float):
        bits = struct.unpack(">Q", struct.pack(">d", v))[0]
        if bits & (1 << 63):
            bits ^= (1 << 64) - 1          # negative: flip all
        else:
            bits ^= 1 << 63                # positive: flip sign
        return bytes([_TAG_FLOAT]) + struct.pack(">Q", bits)
    if isinstance(v, str):
        return bytes([_TAG_STR]) + Codec.encode_bytes(v.encode("utf-8"))
    if isinstance(v, bytes):
        return bytes([_TAG_STR]) + Codec.encode_bytes(v)
    raise TypeError(f"unencodable type {type(v)}")


def decode_value(data: bytes, offset: int = 0) -> Tuple[Any, int]:
    """Returns (value, next_offset)."""
    tag = data[offset]
    offset += 1
    if tag == _TAG_NULL:
        return None, offset
    if tag == _TAG_BOOL:
        return bool(data[offset]), offset + 1
    if tag == _TAG_INT:
        (raw,) = struct.unpack(">Q", data[offset:offset + 8])
        return raw - (1 << 63), offset + 8
    if tag == _TAG_FLOAT:
        (bits,) = struct.unpack(">Q", data[offset:offset + 8])
        if bits & (1 << 63):
            bits ^= 1 << 63
        else:
            bits ^= (1 << 64) - 1
        return struct.unpack(">d", struct.pack(">Q", bits))[0], offset + 8
    if tag == _TAG_STR:
        raw, consumed = Codec.decode_bytes(data[offset:])
        try:
            return raw.decode("utf-8"), offset + consumed
        except UnicodeDecodeError:
            return raw, offset + consumed
    raise ValueError(f"bad tag {tag:#x}")


def encode_row_key(values: Sequence[Any]) -> bytes:
    """Multi-column memcomparable key: tuple ordering == byte ordering."""
    return b"".join(encode_value(v) for v in values)


def decode_row_key(data: bytes) -> List[Any]:
    out: List[Any] = []
    offset = 0
    while offset < len(data):
        v, offset = decode_value(data, offset)
        out.append(v)
    return out
