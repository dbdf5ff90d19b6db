"""Error reporting: Info/Warning/Error/Severe with context (a copy of
tpuprt/utils/errors.py).

The reference's 4-level reporter (core/util.cpp:32-97): Info, Warning and
Error print and continue, Severe raises. The parser passes an explicit
``where`` string (the statement a message is about) instead of the
reference's lexer globals. ``counts`` holds how many of each were printed.
"""
from __future__ import annotations

import sys

counts = {"info": 0, "warning": 0, "error": 0}


class SevereError(RuntimeError):
    """Raised by severe(); the reference aborts (core/util.cpp:92-97)."""


def _emit(level: str, msg: str, where: str | None = None):
    prefix = level.capitalize()
    if where:
        prefix += f" ({where})"
    print(f"{prefix}: {msg}", file=sys.stderr)


def info(msg: str, where: str | None = None):
    counts["info"] += 1
    _emit("info", msg, where)


def warning(msg: str, where: str | None = None):
    counts["warning"] += 1
    _emit("warning", msg, where)


def error(msg: str, where: str | None = None):
    counts["error"] += 1
    _emit("error", msg, where)


def severe(msg: str, where: str | None = None):
    _emit("severe", msg, where)
    raise SevereError(msg)
