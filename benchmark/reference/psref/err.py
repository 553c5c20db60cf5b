"""Leveled logging with pluggable redirection (src/util/err.c,
include/pocketsphinx/err.h).  A copy of `pocketsphinx_tpu.err`.

The reference exposes a tiny logging subsystem as *public API* — level
filtering (`err_set_loglevel`, err.h:135), file redirection
(`err_set_logfile`, err.c:305) and a pluggable callback
(`err_set_callback`) that bindings and the GStreamer element use to
re-route messages.  This module is the same surface in Python:
module-level state, `E_INFO`-style helpers, and `-logfn` wiring from
the decoder config.

Message format matches the reference default callback
(`err_logfp_cb`): ``LEVEL: message`` lines.
"""

from __future__ import annotations

import sys

LEVELS = ("DEBUG", "INFO", "WARN", "ERROR", "FATAL")
_RANK = {name: i for i, name in enumerate(LEVELS)}

_state = {
    "level": "WARN",
    "fp": None,          # None = sys.stderr at call time
    "owns_fp": False,
    "callback": None,    # fn(level: str, message: str) or None
}


def set_loglevel(level: str) -> str:
    """err_set_loglevel: returns the previous level name."""
    level = str(level).upper()
    if level not in _RANK:
        raise ValueError(f"Unknown log level {level!r}")
    old = _state["level"]
    _state["level"] = level
    return old


def get_loglevel() -> str:
    return _state["level"]


def set_logfile(path) -> None:
    """err_set_logfile: redirect messages to `path` (append mode, like
    the reference's fopen(..., "a")).  None restores stderr."""
    if _state["owns_fp"] and _state["fp"] is not None:
        _state["fp"].close()
    if path is None:
        _state["fp"] = None
        _state["owns_fp"] = False
    else:
        _state["fp"] = open(path, "a")
        _state["owns_fp"] = True


def set_logfp(stream) -> None:
    """err_set_logfp: redirect to an open stream (no ownership)."""
    if _state["owns_fp"] and _state["fp"] is not None:
        _state["fp"].close()
    _state["fp"] = stream
    _state["owns_fp"] = False


def set_callback(cb) -> None:
    """err_set_callback: cb(level, message) replaces stream output;
    None restores the default stream behavior."""
    _state["callback"] = cb


def log(level: str, message: str) -> None:
    """E_* core: emit `message` at `level` honoring filter/redirection."""
    if _RANK.get(level, 4) < _RANK[_state["level"]]:
        return
    cb = _state["callback"]
    if cb is not None:
        cb(level, message)
        return
    fp = _state["fp"] or sys.stderr
    fp.write(f"{level}: {message}\n")
    try:
        fp.flush()
    except (OSError, ValueError):
        pass


def E_DEBUG(message: str) -> None:
    log("DEBUG", message)


def E_INFO(message: str) -> None:
    log("INFO", message)


def E_WARN(message: str) -> None:
    log("WARN", message)


def E_ERROR(message: str) -> None:
    log("ERROR", message)


def E_FATAL(message: str) -> None:
    log("FATAL", message)
