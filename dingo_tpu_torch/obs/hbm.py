"""Device allocation-failure classification (port of ``looks_like_oom`` in
dingo_tpu/obs/hbm.py).

The JAX package matches the text of an XlaRuntimeError
(RESOURCE_EXHAUSTED). On the card an allocation failure has a type of its
own, ``torch.cuda.OutOfMemoryError`` (``torch.OutOfMemoryError``), and the
chaos shim raises ``InjectedDeviceFault`` (ops/devfault.py); those two
and nothing else walk the recovery ladder, so no error whose message
happens to say "out of memory" is mistaken for one. The per-region
ledger (``HbmLedger``) is not ported: nothing on the ported paths reads
it.
"""

from __future__ import annotations

import torch

from dingo_tpu_torch.ops.devfault import InjectedDeviceFault

__all__ = ["looks_like_oom"]


def _oom_types():
    t = getattr(torch, "OutOfMemoryError", None)
    if t is None:
        t = getattr(torch.cuda, "OutOfMemoryError", None)
    return (InjectedDeviceFault,) + ((t,) if t is not None else ())


_OOM_TYPES = _oom_types()


def looks_like_oom(exc: BaseException) -> bool:
    """True for a device allocation failure: a torch out-of-memory error
    or an injected device fault."""
    return isinstance(exc, _OOM_TYPES)
