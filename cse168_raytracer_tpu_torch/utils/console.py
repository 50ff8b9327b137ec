"""Levelled ANSI console logging (Console.{h,cpp}).

Counterpart of cse168_raytracer_tpu/utils/console.py, same API: debug,
info, warning, error and fatal printf-style helpers with the
reference's ANSI colours (Console.cpp:18-24) on top of Python logging,
so a library user can silence or redirect them (the logger
"miro_tpu_torch", on the current sys.stderr, level INFO). Colours only on a terminal;
fatal logs and raises SystemExit(1) where the reference exits.
"""

from __future__ import annotations

import logging
import sys

_ANSI = {"debug": "\033[37m", "info": "\033[0m", "warning": "\033[33m",
         "error": "\033[31m", "fatal": "\033[1;31m"}
_RESET = "\033[0m"



class _StderrHandler(logging.StreamHandler):
    """A StreamHandler on whatever sys.stderr is when a record is
    emitted, so contextlib.redirect_stderr captures the lines."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _value):
        pass


logger = logging.getLogger("miro_tpu_torch")
if not logger.handlers:
    _handler = _StderrHandler()
    _handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)


def _emit(level: str, msg: str, *args) -> None:
    text = (msg % args) if args else msg
    color = _ANSI.get(level, "") if sys.stderr.isatty() else ""
    reset = _RESET if color else ""
    getattr(logger, "critical" if level == "fatal" else level)(
        f"{color}{text}{reset}")


def debug(msg, *args):
    _emit("debug", msg, *args)


def info(msg, *args):
    _emit("info", msg, *args)


def warning(msg, *args):
    _emit("warning", msg, *args)


def error(msg, *args):
    _emit("error", msg, *args)


def fatal(msg, *args):
    """Console.h's fatal: log and raise (the reference exits)."""
    _emit("fatal", msg, *args)
    raise SystemExit(1)
