"""Leveled structured logger (a copy of ``gofr_tpu/logging/logger.py``):
JSON lines to pipes, colored pretty-print to TTYs, and a ``pretty_print``
duck method so a payload renders itself in terminal mode. A line written
under a span of the port's tracer carries its trace and span ids.
"""

from __future__ import annotations

import enum
import io
import json
import os
import sys
import threading
import time
from typing import Any, Optional, TextIO


class Level(enum.IntEnum):
    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    FATAL = 6

    @staticmethod
    def parse(name: str, default: "Level" = None) -> "Level":
        try:
            return Level[name.strip().upper()]
        except (KeyError, AttributeError):
            return default if default is not None else Level.INFO


_LEVEL_COLORS = {
    Level.DEBUG: "\033[36m",   # cyan
    Level.INFO: "\033[32m",    # green
    Level.NOTICE: "\033[34m",  # blue
    Level.WARN: "\033[33m",    # yellow
    Level.ERROR: "\033[31m",   # red
    Level.FATAL: "\033[35m",   # magenta
}
_RESET = "\033[0m"


class Logger:
    """Thread-safe leveled logger.

    Output mode is chosen per-stream: TTY → colored human format, otherwise
    one JSON object per line (reference: logging/logger.go:208-215
    ``checkIfTerminal``).
    """

    def __init__(self, level: Level = Level.INFO,
                 out: Optional[TextIO] = None, err: Optional[TextIO] = None):
        self.level = level
        self._out = out if out is not None else sys.stdout
        self._err = err if err is not None else sys.stderr
        self._lock = threading.Lock()

    # -- level management (reference: logging/logger.go:36 ChangeLevel) ----
    def change_level(self, level: Level) -> None:
        self.level = level

    # -- emit ---------------------------------------------------------------
    def _is_terminal(self, stream: TextIO) -> bool:
        try:
            return stream.isatty()
        except (AttributeError, ValueError, io.UnsupportedOperation):
            return False

    def logf(self, level: Level, message: str, *args: Any, **fields: Any) -> None:
        if level < self.level:
            return
        stream = self._err if level >= Level.ERROR else self._out
        if args:
            try:
                message = message % args
            except (TypeError, ValueError):
                message = " ".join([message] + [str(a) for a in args])
        payload = fields.pop("payload", None)
        entry = {
            "level": level.name,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
                    + f".{int((time.time() % 1) * 1e6):06d}Z",
            "message": message,
        }
        trace_id, span_id = _current_trace_ids()
        if trace_id:
            entry["trace_id"] = trace_id
            entry["span_id"] = span_id
        if fields:
            entry.update(fields)
        with self._lock:
            try:
                if self._is_terminal(stream):
                    self._write_pretty(stream, level, entry, payload)
                else:
                    if payload is not None:
                        entry["payload"] = _jsonable(payload)
                    stream.write(json.dumps(entry, default=str) + "\n")
                stream.flush()
            except (OSError, ValueError):
                pass

    def _write_pretty(self, stream: TextIO, level: Level, entry: dict, payload: Any) -> None:
        color = _LEVEL_COLORS.get(level, "")
        head = f"{color}{level.name:<6}{_RESET} [{entry['time']}] "
        if "trace_id" in entry:
            head += f"\033[90m{entry['trace_id']}\033[0m "
        stream.write(head + str(entry["message"]))
        extras = {k: v for k, v in entry.items()
                  if k not in ("level", "time", "message", "trace_id",
                               "span_id")}
        if extras:
            stream.write(" " + json.dumps(extras, default=str))
        stream.write("\n")
        # PrettyPrint duck typing (reference: logging/logger.go:17-19)
        if payload is not None:
            if hasattr(payload, "pretty_print"):
                payload.pretty_print(stream)
            else:
                stream.write("  " + json.dumps(_jsonable(payload), default=str) + "\n")

    # -- convenience levels -------------------------------------------------
    def debug(self, message: str, *args: Any, **fields: Any) -> None:
        self.logf(Level.DEBUG, message, *args, **fields)

    def info(self, message: str, *args: Any, **fields: Any) -> None:
        self.logf(Level.INFO, message, *args, **fields)

    def notice(self, message: str, *args: Any, **fields: Any) -> None:
        self.logf(Level.NOTICE, message, *args, **fields)

    def warn(self, message: str, *args: Any, **fields: Any) -> None:
        self.logf(Level.WARN, message, *args, **fields)

    def error(self, message: str, *args: Any, **fields: Any) -> None:
        self.logf(Level.ERROR, message, *args, **fields)

    # the stdlib's names, which the port's engine and fleet call too
    def warning(self, message: str, *args: Any, **fields: Any) -> None:
        self.logf(Level.WARN, message, *args, **fields)

    def exception(self, message: str, *args: Any, **fields: Any) -> None:
        """ERROR, with the exception being handled as ``exc``."""
        fields.setdefault("exc", repr(sys.exc_info()[1]))
        self.logf(Level.ERROR, message, *args, **fields)

    def fatal(self, message: str, *args: Any, **fields: Any) -> None:
        self.logf(Level.FATAL, message, *args, **fields)


def _jsonable(obj: Any) -> Any:
    if hasattr(obj, "to_log"):
        return obj.to_log()
    if hasattr(obj, "__dict__"):
        return {k: v for k, v in vars(obj).items() if not k.startswith("_")}
    return obj


def _current_trace_ids() -> "tuple[Optional[str], Optional[str]]":
    """(trace_id, span_id) of the active span — every log line written
    under a span is joinable against the trace store and the flight
    recorder's request timelines."""
    # Imported lazily to avoid a circular dependency logging <-> trace.
    try:
        from gofr_tpu_torch.trace.tracer import current_span
        span = current_span()
        if span is None:
            return None, None
        return span.trace_id, span.span_id
    except Exception:
        return None, None


def new_logger(level: Level = Level.INFO) -> Logger:
    return Logger(level=level)


def new_file_logger(path: str, level: Level = Level.INFO) -> Logger:
    """Logger writing to a file — used by CMD apps so stdout stays clean for
    command output (reference: logging/logger.go:187-206 ``NewFileLogger``,
    gofr.go:100-103 ``CMD_LOGS_FILE``)."""
    if not path:
        stream: TextIO = open(os.devnull, "w")  # noqa: SIM115 - lifetime = process
    else:
        stream = open(path, "a", encoding="utf-8")  # noqa: SIM115
    return Logger(level=level, out=stream, err=stream)


def new_silent_logger() -> Logger:
    """Logger that drops everything — test fixture."""
    null = open(os.devnull, "w")  # noqa: SIM115 - lifetime = process
    return Logger(level=Level.FATAL, out=null, err=null)
