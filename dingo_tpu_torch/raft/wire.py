"""Typed wire codec for raft RPC payloads (port of dingo_tpu/raft/wire.py).

The reference transports typed protobuf messages over braft/brpc; round 1
used pickle here, which turns the raft port into arbitrary code execution
for anyone who can reach it. Raft messages are plain trees of
None/bool/int/float/str/bytes/list/tuple/dict, so a tag-length-value codec
covers them exactly — decoding allocates only those types and can never
execute code. Tuples decode as lists (callers only iterate/unpack).
"""

from __future__ import annotations

import struct
from typing import Any

_NONE, _TRUE, _FALSE, _INT, _FLOAT, _STR, _BYTES, _LIST, _DICT = range(9)

_MAX_DEPTH = 32


class WireError(ValueError):
    pass


def _enc(obj: Any, out: list, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise WireError("encode: nesting too deep")
    if obj is None:
        out.append(bytes([_NONE]))
    elif obj is True:
        out.append(bytes([_TRUE]))
    elif obj is False:
        out.append(bytes([_FALSE]))
    elif isinstance(obj, int):
        if not -(2**63) <= obj < 2**63:
            raise WireError(f"int out of signed-64 range: {obj}")
        out.append(struct.pack(">Bq", _INT, obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", _FLOAT, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(struct.pack(">BQ", _STR, len(raw)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(struct.pack(">BQ", _BYTES, len(raw)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(struct.pack(">BQ", _LIST, len(obj)))
        for item in obj:
            _enc(item, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(struct.pack(">BQ", _DICT, len(obj)))
        for key, val in obj.items():
            if not isinstance(key, str):
                raise WireError(f"dict key must be str, got {type(key)}")
            _enc(key, out, depth + 1)
            _enc(val, out, depth + 1)
    else:
        raise WireError(f"unsupported wire type: {type(obj)}")


def encode(obj: Any) -> bytes:
    out: list = []
    _enc(obj, out, 0)
    return b"".join(out)


def _dec(buf: bytes, pos: int, depth: int):
    if depth > _MAX_DEPTH:
        raise WireError("decode: nesting too deep")
    if pos >= len(buf):
        raise WireError("decode: truncated")
    tag = buf[pos]
    pos += 1
    if tag == _NONE:
        return None, pos
    if tag == _TRUE:
        return True, pos
    if tag == _FALSE:
        return False, pos
    if tag == _INT:
        if pos + 8 > len(buf):
            raise WireError("decode: truncated int")
        return struct.unpack_from(">q", buf, pos)[0], pos + 8
    if tag == _FLOAT:
        if pos + 8 > len(buf):
            raise WireError("decode: truncated float")
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if tag in (_STR, _BYTES):
        if pos + 8 > len(buf):
            raise WireError("decode: truncated length")
        (n,) = struct.unpack_from(">Q", buf, pos)
        pos += 8
        if pos + n > len(buf):
            raise WireError("decode: truncated payload")
        raw = buf[pos : pos + n]
        pos += n
        if tag == _STR:
            try:
                return raw.decode("utf-8"), pos
            except UnicodeDecodeError as e:
                raise WireError(f"decode: invalid utf-8 in str: {e}") from e
        return raw, pos
    if tag == _LIST:
        if pos + 8 > len(buf):
            raise WireError("decode: truncated count")
        (n,) = struct.unpack_from(">Q", buf, pos)
        pos += 8
        if n > len(buf):  # each element costs >= 1 byte
            raise WireError("decode: list count exceeds buffer")
        items = []
        for _ in range(n):
            item, pos = _dec(buf, pos, depth + 1)
            items.append(item)
        return items, pos
    if tag == _DICT:
        if pos + 8 > len(buf):
            raise WireError("decode: truncated count")
        (n,) = struct.unpack_from(">Q", buf, pos)
        pos += 8
        if n > len(buf):
            raise WireError("decode: dict count exceeds buffer")
        d = {}
        for _ in range(n):
            key, pos = _dec(buf, pos, depth + 1)
            if not isinstance(key, str):
                raise WireError("decode: dict key must be str")
            val, pos = _dec(buf, pos, depth + 1)
            d[key] = val
        return d, pos
    raise WireError(f"decode: unknown tag {tag}")


def decode(buf: bytes) -> Any:
    obj, pos = _dec(buf, 0, 0)
    if pos != len(buf):
        raise WireError(f"decode: {len(buf) - pos} trailing bytes")
    return obj


# -- object layer: plain trees + numpy arrays --------------------------------
# ndarray envelope key set; a user dict can only collide by carrying exactly
# these four keys, and the decoder then validates every field strictly
_ND_KEYS = frozenset(("__nd__", "dtype", "shape", "data"))


def to_plain(v: Any) -> Any:
    """Normalize a value tree for encode(): ndarrays become tagged dicts."""
    import numpy as np

    if isinstance(v, np.ndarray):
        return {
            "__nd__": True,
            "dtype": str(v.dtype),
            "shape": [int(s) for s in v.shape],
            "data": v.tobytes(),
        }
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, (list, tuple)):
        return [to_plain(i) for i in v]
    if isinstance(v, dict):
        return {k: to_plain(x) for k, x in v.items()}
    return v


def from_plain(v: Any) -> Any:
    """Inverse of to_plain. Raises WireError on a malformed nd envelope
    (bad dtype, negative shape, size mismatch) — never ValueError."""
    import numpy as np

    if isinstance(v, dict):
        if v.get("__nd__") is True and set(v) == _ND_KEYS:
            try:
                dtype = np.dtype(v["dtype"])
                shape = [int(s) for s in v["shape"]]
                data = v["data"]
                if not isinstance(data, bytes):
                    raise WireError("nd envelope: data must be bytes")
                if any(s < 0 for s in shape):
                    raise WireError("nd envelope: negative shape")
                count = int(np.prod(shape)) if shape else 1
                if count * dtype.itemsize != len(data):
                    raise WireError(
                        f"nd envelope: {len(data)} bytes != "
                        f"shape {shape} x {dtype}"
                    )
                return np.frombuffer(data, dtype=dtype).reshape(shape)
            except WireError:
                raise
            except (TypeError, ValueError) as e:
                raise WireError(f"nd envelope: {e}") from e
        return {k: from_plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [from_plain(i) for i in v]
    return v


def encode_obj(obj: Any) -> bytes:
    """encode() over to_plain-normalized input: accepts numpy arrays and
    numpy scalar types anywhere in the tree."""
    return encode(to_plain(obj))


def decode_obj(buf: bytes) -> Any:
    return from_plain(decode(buf))


def blob_checksum(blob: bytes) -> int:
    """Integrity checksum for transfer blobs (BR region export/import).
    One definition shared by client and server — the two sides silently
    disagreeing would fail every transfer. crc32: C-speed on multi-MB
    blobs."""
    import zlib

    return zlib.crc32(blob) & 0xFFFFFFFF
