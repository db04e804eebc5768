"""MVCC key/value codec (port of dingo_tpu/mvcc/codec.py).

Reference: src/mvcc/codec.h:30-106 — keys are memcomparable-encoded user keys
with an inverted-timestamp suffix (so for one user key, newer versions sort
first in an ascending scan); values carry a trailing flag byte
{kPut, kPutTTL, kDelete}, with kPutTTL holding an 8-byte expire-ms field
before the flag. The dingo-serial submodule defines the memcomparable byte
encoding; we reproduce the standard group-of-8 scheme (pad each 8-byte group
with NULs and append marker 0xFF - pad_count) which preserves lexicographic
order through the ts suffix.
"""

from __future__ import annotations

import enum
import struct
from typing import Optional, Tuple

MAX_TS = (1 << 64) - 1
_GROUP = 8
_MARKER_FULL = 0xFF


class ValueFlag(enum.IntEnum):
    """codec.h:30-34."""

    PUT = 0
    PUT_TTL = 1
    DELETE = 2


_PUT = int(ValueFlag.PUT)


class Codec:
    # -- memcomparable bytes -------------------------------------------------
    @staticmethod
    def encode_bytes(data: bytes) -> bytes:
        """Order-preserving encoding: groups of 8 bytes, each followed by a
        marker 0xFF - pad (a shorter key is a prefix group with pad > 0 and
        sorts before any longer key sharing the prefix)."""
        out = bytearray()
        i = 0
        while i <= len(data):  # <=: an exact multiple emits a final pad group
            group = data[i : i + _GROUP]
            pad = _GROUP - len(group)
            out += group + b"\x00" * pad
            out.append(_MARKER_FULL - pad)
            i += _GROUP
        return bytes(out)

    @staticmethod
    def decode_bytes(enc: bytes) -> Tuple[bytes, int]:
        """Returns (data, bytes_consumed). Finds the first group whose
        marker is not full, then joins the groups up to it (the engine
        scans decode a key a row, so this stays one pass of index reads)."""
        n = len(enc)
        i = _GROUP                       # position of the first marker
        while True:
            if i >= n:
                raise ValueError("truncated memcomparable bytes")
            marker = enc[i]
            if marker != _MARKER_FULL:
                break
            i += _GROUP + 1
        pad = _MARKER_FULL - marker
        if not 0 <= pad <= _GROUP:
            raise ValueError(f"bad marker {marker:#x}")
        last = enc[i - _GROUP:i - pad]
        if i == _GROUP:
            return last, i + 1
        return (b"".join([enc[j:j + _GROUP]
                          for j in range(0, i - _GROUP, _GROUP + 1)])
                + last, i + 1)

    # -- versioned keys --------------------------------------------------------
    @staticmethod
    def encode_key(user_key: bytes, ts: int) -> bytes:
        """encoded user key + inverted big-endian ts (newer sorts first)."""
        return Codec.encode_bytes(user_key) + struct.pack(">Q", MAX_TS - ts)

    @staticmethod
    def decode_key(enc: bytes) -> Tuple[bytes, int]:
        user_key, consumed = Codec.decode_bytes(enc)
        if len(enc) - consumed != 8:
            raise ValueError("missing ts suffix")
        (inv,) = struct.unpack(">Q", enc[consumed:])
        return user_key, MAX_TS - inv

    @staticmethod
    def max_ts_key(user_key: bytes) -> bytes:
        """Seek key positioned at the NEWEST version of user_key."""
        return Codec.encode_key(user_key, MAX_TS)

    @staticmethod
    def min_ts_key(user_key: bytes) -> bytes:
        return Codec.encode_key(user_key, 0)

    # -- values ----------------------------------------------------------------
    @staticmethod
    def package_value(
        payload: bytes, flag: ValueFlag = ValueFlag.PUT, ttl_ms: int = 0
    ) -> bytes:
        if flag is ValueFlag.PUT_TTL:
            return payload + struct.pack(">Q", ttl_ms) + bytes([flag])
        if flag is ValueFlag.DELETE:
            return bytes([flag])
        return payload + bytes([flag])

    @staticmethod
    def unpackage_value(value: bytes) -> Tuple[ValueFlag, bytes, int]:
        """Returns (flag, payload, ttl_ms)."""
        if not value:
            raise ValueError("empty mvcc value")
        if value[-1] == _PUT:      # the common case: no enum lookup
            return ValueFlag.PUT, value[:-1], 0
        flag = ValueFlag(value[-1])
        if flag is ValueFlag.DELETE:
            return flag, b"", 0
        if flag is ValueFlag.PUT_TTL:
            if len(value) < 9:
                raise ValueError("short PUT_TTL value")
            (ttl,) = struct.unpack(">Q", value[-9:-1])
            return flag, value[:-9], ttl
        return flag, value[:-1], 0
