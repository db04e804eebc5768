"""Typed persistence codec for local disk/meta-CF state
(port of dingo_tpu/common/persist.py).

Round-1/2 persisted coordinator, region, and document state with pickle:
restoring a tampered backup or snapshot was arbitrary code execution, and
the format was version-fragile. The wire TLV codec (raft/wire.py) already
covers plain trees; this module adds the typed layer — a REGISTRY of
allowed dataclasses and enums, encoded as tagged plain trees — so decoding
allocates only registered types and never executes code (the reference
persists typed protobuf everywhere for the same reason).

Envelope forms inside the plain tree:
  {"__dc": "Name", "f": {field: value}}   registered dataclass
  {"__en": "Name", "v": value}            registered enum
  {"__d": [[k, v], ...]}                  dict with non-str keys
  {"__t": [items]}                        tuple (lists encode bare)

Pickle blobs are never read: the port has no pickled state to migrate,
so the JAX package's DINGO_ALLOW_PICKLE_MIGRATION opt-in is not carried.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Type

from dingo_tpu_torch.raft import wire

_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator: allow this dataclass/enum in persisted state."""
    prior = _REGISTRY.get(cls.__name__)
    if prior is not None and prior is not cls:
        raise TypeError(
            f"persist name collision: {cls.__name__} already registered "
            f"from {prior.__module__} — persisted blobs are keyed by class "
            "name, rename one of them"
        )
    _REGISTRY[cls.__name__] = cls
    return cls


def _ensure_registered(cls: type) -> str:
    name = cls.__name__
    if _REGISTRY.get(name) is not cls:
        raise TypeError(
            f"{name} is not persist.register()ed — refusing to serialize "
            "an unvetted type"
        )
    return name


def to_plain(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        name = _ensure_registered(type(v))
        return {
            "__dc": name,
            "f": {
                f.name: to_plain(getattr(v, f.name))
                for f in dataclasses.fields(v)
            },
        }
    if isinstance(v, enum.Enum):
        return {"__en": _ensure_registered(type(v)), "v": v.value}
    if isinstance(v, dict):
        if all(isinstance(k, str) for k in v) and not (
            set(v) & {"__dc", "__en", "__d", "__t"}
        ):
            return {k: to_plain(x) for k, x in v.items()}
        return {"__d": [[to_plain(k), to_plain(x)] for k, x in v.items()]}
    if isinstance(v, tuple):
        return {"__t": [to_plain(i) for i in v]}
    if isinstance(v, list):
        return [to_plain(i) for i in v]
    return v


def from_plain(v: Any) -> Any:
    if isinstance(v, dict):
        if "__dc" in v:
            cls = _REGISTRY.get(v["__dc"])
            if cls is None or not dataclasses.is_dataclass(cls):
                raise wire.WireError(f"unknown dataclass {v.get('__dc')!r}")
            try:
                fields = {k: from_plain(x) for k, x in v["f"].items()}
                known = {f.name for f in dataclasses.fields(cls)}
                # forward/backward compat: drop unknown fields, let
                # defaults fill missing ones
                return cls(**{k: x for k, x in fields.items() if k in known})
            except wire.WireError:
                raise
            except Exception as e:
                # corrupt/version-skewed state keeps the documented error
                # contract (callers catch WireError, not constructor noise)
                raise wire.WireError(
                    f"malformed {v['__dc']} envelope: {e}"
                ) from e
        if "__en" in v:
            cls = _REGISTRY.get(v["__en"])
            if cls is None or not issubclass(cls, enum.Enum):
                raise wire.WireError(f"unknown enum {v.get('__en')!r}")
            try:
                return cls(v["v"])
            except Exception as e:
                raise wire.WireError(
                    f"malformed {v['__en']} envelope: {e}"
                ) from e
        if "__d" in v:
            return {from_plain(k): from_plain(x) for k, x in v["__d"]}
        if "__t" in v:
            return tuple(from_plain(i) for i in v["__t"])
        return {k: from_plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [from_plain(i) for i in v]
    return v


def dumps(obj: Any) -> bytes:
    return wire.encode(to_plain(obj))


def loads(blob: bytes) -> Any:
    try:
        tree = wire.decode(blob)
    except wire.WireError as e:
        raise wire.WireError(
            "blob is not in the typed persist format") from e
    return from_plain(tree)
