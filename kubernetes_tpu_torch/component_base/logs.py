"""Structured logging (klog v2 contract).

Reference: component-base/logs — klog InfoS/ErrorS structured key-value
logging, a JSON output format option (logs/json/register), and V-level
verbosity gating expensive paths (e.g. schedule_one.go:705 V(10) score
dumps).  Implemented over the stdlib logging module so existing module
loggers keep working; InfoS/ErrorS render 'msg key=value ...' or JSON.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Any

_state = threading.local()
_verbosity = 0
_json_format = False


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def get_verbosity() -> int:
    return _verbosity


def enabled(v: int) -> bool:
    """klog V(v).Enabled() — gate expensive log construction."""
    return _verbosity >= v


def set_format(fmt: str) -> None:
    """'text' (default) or 'json' (logs/json/register analogue)."""
    global _json_format
    if fmt not in ("text", "json"):
        raise ValueError("unknown log format %r" % fmt)
    _json_format = fmt == "json"


def _render(msg: str, kv: dict) -> str:
    if _json_format:
        rec = {"ts": time.time(), "msg": msg}
        rec.update({k: _jsonable(v) for k, v in kv.items()})
        return json.dumps(rec)
    if not kv:
        return msg
    return msg + " " + " ".join('%s="%s"' % (k, v) for k, v in kv.items())


def _jsonable(v: Any):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return str(v)


def info_s(logger: logging.Logger, msg: str, **kv: Any) -> None:
    logger.info(_render(msg, kv))


def error_s(logger: logging.Logger, err: Exception | None, msg: str,
            **kv: Any) -> None:
    if err is not None:
        kv = dict(kv, err=str(err))
    logger.error(_render(msg, kv))


def v(level: int):
    """Usage: logs.v(10) and logs.v(10).info_s(logger, ...)."""
    return _VLogger(level)


class _VLogger:
    __slots__ = ("level",)

    def __init__(self, level: int):
        self.level = level

    def __bool__(self) -> bool:
        return enabled(self.level)

    def info_s(self, logger: logging.Logger, msg: str, **kv: Any) -> None:
        if enabled(self.level):
            info_s(logger, msg, **kv)


def init_logs(verbosity: int = 0, fmt: str = "text",
              stream=None) -> None:
    """cli entry-point setup (component-base/logs InitLogs)."""
    set_verbosity(verbosity)
    set_format(fmt)
    logging.basicConfig(
        stream=stream or sys.stderr,
        level=logging.DEBUG if verbosity >= 4 else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s")
