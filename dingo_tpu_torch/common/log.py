"""Module-tagged structured logging with runtime level control (the port's
copy of dingo_tpu/common/log.py).

    log = get_logger("trace")                # logger "dingo.trace"
    log.info("...")                          # [trace] ...
    rlog = region_log(log, region_id=7)      # [trace][region(7)] ...
    set_level("DEBUG")                       # whole tree at runtime
    set_level("INFO", module="trace")        # one subtree

Every logger lives under the "dingo" root; one stderr handler renders
`HH:MM:SS.mmm LEVEL [module][region(N)] message`. The default level is
WARNING; the DINGO_LOG environment variable or set_level raise it. The
root gets a handler only when it has none, so a process that also loads
the JAX package logs each line once.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Dict, Optional

_ROOT = "dingo"
_LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL")
_configured = False
_config_lock = threading.Lock()


class _TagFormatter(logging.Formatter):
    """`HH:MM:SS.mmm LEVEL [module][region(N)] message`."""

    def format(self, record: logging.LogRecord) -> str:
        module = record.name
        if module.startswith(_ROOT + "."):
            module = module[len(_ROOT) + 1:]
        elif module == _ROOT:
            module = "core"
        tag = f"[{module}]"
        region = getattr(record, "region_id", None)
        if region is not None:
            tag += f"[region({region})]"
        when = self.formatTime(record, "%H:%M:%S")
        s = (f"{when}.{int(record.msecs):03d} {record.levelname} "
             f"{tag} {record.getMessage()}")
        if record.exc_info:
            s += "\n" + self.formatException(record.exc_info)
        return s


def _ensure_configured() -> None:
    global _configured
    if _configured:
        return
    with _config_lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT)
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(_TagFormatter())
            root.addHandler(handler)
            root.propagate = False
            env = os.environ.get("DINGO_LOG", "").upper()
            root.setLevel(env if env in _LEVELS else logging.WARNING)
        _configured = True


def get_logger(module: str) -> logging.Logger:
    """Logger tagged `[module]` (dotted subtags control subtrees)."""
    _ensure_configured()
    return logging.getLogger(f"{_ROOT}.{module}")


class _RegionAdapter(logging.LoggerAdapter):
    def process(self, msg, kwargs):
        kwargs.setdefault("extra", {})["region_id"] = self.extra["region_id"]
        return msg, kwargs


def region_log(log: logging.Logger, region_id: int) -> logging.LoggerAdapter:
    """`[module][region(N)]`-tagged view of a module logger."""
    return _RegionAdapter(log, {"region_id": region_id})


def set_level(level: str, module: Optional[str] = None) -> None:
    """Runtime level control. module=None (or "dingo") sets the whole
    tree; a dotted module sets that subtree. Accepts both bare ("trace")
    and "dingo."-prefixed names."""
    _ensure_configured()
    level = level.upper()
    if level not in _LEVELS:
        raise ValueError(f"unknown log level {level!r} (use {_LEVELS})")
    if module and module.startswith(_ROOT + "."):
        module = module[len(_ROOT) + 1:]
    if module in (None, "", _ROOT):
        name = _ROOT
    else:
        name = f"{_ROOT}.{module}"
    logging.getLogger(name).setLevel(level)


def get_levels() -> Dict[str, str]:
    """Effective levels of every live dingo logger (NodeService
    GetLogLevel)."""
    _ensure_configured()
    out = {}
    root = logging.getLogger(_ROOT)
    out[_ROOT] = logging.getLevelName(root.getEffectiveLevel())
    for name, logger in list(logging.Logger.manager.loggerDict.items()):
        if name.startswith(_ROOT + ".") and isinstance(
                logger, logging.Logger):
            out[name] = logging.getLevelName(logger.getEffectiveLevel())
    return out
