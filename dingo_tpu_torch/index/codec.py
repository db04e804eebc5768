"""Vector key codec (port of dingo_tpu/index/codec.py).

Reference: src/vector/codec.{h,cc} (codec.h:28-66) — vector keys are
`prefix + partition_id + vector_id [+ scalar_key]` in big-endian so ranges
sort correctly, with encoded (memcomparable + ts) variants for the MVCC CFs;
DecodeRangeToVectorId (:75) recovers the id window from a region range.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

VECTOR_PREFIX = b"r"
MAX_VECTOR_ID = (1 << 63) - 1
#: a vector id's big-endian int64 (after the prefix byte and the partition)
VECTOR_ID_STRUCT = struct.Struct(">q")


def encode_vector_key(partition_id: int, vector_id: Optional[int] = None,
                      scalar_key: bytes = b"") -> bytes:
    out = VECTOR_PREFIX + struct.pack(">q", partition_id)
    if vector_id is not None:
        out += struct.pack(">q", vector_id)
    return out + scalar_key


def decode_vector_key(key: bytes) -> Tuple[int, Optional[int], bytes]:
    """Returns (partition_id, vector_id|None, scalar_key)."""
    if not key.startswith(VECTOR_PREFIX):
        raise ValueError(f"bad vector key prefix {key[:1]!r}")
    body = key[1:]
    (partition_id,) = struct.unpack(">q", body[:8])
    if len(body) == 8:
        return partition_id, None, b""
    (vector_id,) = struct.unpack(">q", body[8:16])
    return partition_id, vector_id, body[16:]


def partition_range(partition_id: int) -> Tuple[bytes, bytes]:
    """Full key range of one partition."""
    return (
        encode_vector_key(partition_id),
        encode_vector_key(partition_id + 1),
    )


def range_to_vector_ids(start_key: bytes, end_key: bytes) -> Tuple[int, int]:
    """Region range -> [start_vector_id, end_vector_id) window
    (DecodeRangeToVectorId, codec.h:75)."""
    sp, sv, _ = decode_vector_key(start_key)
    start_id = sv if sv is not None else 0
    try:
        ep, ev, _ = decode_vector_key(end_key)
        if ev is None:
            end_id = MAX_VECTOR_ID
        else:
            end_id = ev
    except (ValueError, struct.error):
        end_id = MAX_VECTOR_ID
    return start_id, end_id
