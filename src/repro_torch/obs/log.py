"""Structured logging for the port: one event name + key=value fields.

The reference's ``obs/log.py`` with the logger hierarchy rooted at
``"repro_torch"``.  Every consumer (a human tailing stderr, a log shipper,
a test asserting on records) sees one uniform shape::

    _log = get_logger(__name__)
    _log.info("apply_delta.full_rebuild", new_nodes=3)
    # -> "apply_delta.full_rebuild new_nodes=3"

Configuration is module-level and env-driven: the first :func:`get_logger`
call installs one stderr handler on the ``"repro_torch"`` root logger
(unless the embedding application already configured one) and sets its
level from ``REPRO_OBS_LOG`` (``debug`` / ``info`` / ``warning`` /
``error``; default ``warning``, so routine fallback notices stay quiet in
tests and benches).  The underlying stdlib loggers stay reachable via
``logging.getLogger`` for tests and embedders who want their own handlers
or levels.

The module also keeps a small in-process **tail buffer** (a bounded deque
fed by a dedicated handler on the ``"repro_torch"`` root): the last few
hundred records that passed the configured level, as plain dicts.  Debug
bundles (:meth:`repro_torch.obs.flight.FlightRecorder.debug_bundle`) embed
this tail so a postmortem artifact carries the log lines surrounding the
incident without anyone having had to redirect stderr in advance.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["get_logger", "StructLogger", "format_event", "tail",
           "clear_tail"]

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "warn": logging.WARNING,
           "error": logging.ERROR, "critical": logging.CRITICAL}

_ROOT = "repro_torch"
_configured = False
_config_lock = threading.Lock()

# bounded in-process record tail for debug bundles; records that pass the
# configured "repro_torch" level land here as plain dicts regardless of what
# stream/file handlers the embedder installed
_TAIL: deque = deque(maxlen=256)


class _TailHandler(logging.Handler):
    """Appends every record to the bounded module tail; never raises."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            _TAIL.append({"unix_ts": record.created,
                          "level": record.levelname,
                          "logger": record.name,
                          "message": record.getMessage()})
        except Exception:
            pass


def tail(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Last ``n`` (default: all buffered) structured-log records, oldest
    first, as plain JSON-ready dicts."""
    _ensure_configured()
    out = list(_TAIL)
    return out[-n:] if n is not None else out


def clear_tail() -> None:
    _TAIL.clear()


def _ensure_configured() -> None:
    global _configured
    if _configured:
        return
    with _config_lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT)
        if not root.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s :: %(message)s"))
            root.addHandler(h)
        # the tail handler is additive: installed even when the embedder
        # brought its own handlers, so debug bundles always have a log tail
        if not any(isinstance(h, _TailHandler) for h in root.handlers):
            root.addHandler(_TailHandler())
        lvl = os.environ.get("REPRO_OBS_LOG", "warning").strip().lower()
        root.setLevel(_LEVELS.get(lvl, logging.WARNING))
        _configured = True


def format_event(event: str, fields: Dict[str, Any]) -> str:
    if not fields:
        return event
    parts = []
    for k in sorted(fields):
        v = fields[k]
        parts.append(f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}")
    return event + " " + " ".join(parts)


class StructLogger:
    """Thin structured facade over one stdlib logger."""

    __slots__ = ("_log",)

    def __init__(self, logger: logging.Logger):
        self._log = logger

    @property
    def stdlib(self) -> logging.Logger:
        return self._log

    def _emit(self, level: int, event: str, fields: Dict[str, Any],
              exc_info: bool = False) -> None:
        if self._log.isEnabledFor(level):
            self._log.log(level, format_event(event, fields),
                          exc_info=exc_info)

    def debug(self, event: str, **fields: Any) -> None:
        self._emit(logging.DEBUG, event, fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit(logging.INFO, event, fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit(logging.ERROR, event, fields)

    def exception(self, event: str, **fields: Any) -> None:
        """Error-level event with the active exception's traceback."""
        self._emit(logging.ERROR, event, fields, exc_info=True)


def get_logger(name: str = _ROOT) -> StructLogger:
    """Structured logger under the ``"repro_torch"`` hierarchy.

    ``get_logger(__name__)`` from inside the package lands on the module's
    natural logger; any other name is nested under ``repro_torch.`` so one
    root handler/level governs everything.
    """
    _ensure_configured()
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return StructLogger(logging.getLogger(name))
