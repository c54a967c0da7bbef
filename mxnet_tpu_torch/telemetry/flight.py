"""Crash flight recorder: "what was the process doing when it died".

An unhandled exception deep in a worker thread ends a process, and the
evidence with it. The flight recorder freezes it at that moment: the
span ring's recent history (every request and step the process was
working on) and a full registry snapshot (the stat views and the native
metrics), in one JSON file written atomically (tmp + os.replace), so a
crash during the dump never leaves a torn file.

Enablement: MXNET_TELEMETRY_FLIGHT_DIR=<dir>. When it is set,
`install()` (done at `mxnet_tpu_torch.telemetry` import) chains
sys.excepthook and threading.excepthook, so any unhandled exception
dumps before the interpreter unwinds. When it is unset every entry point
is a cheap no-op. `fault.FaultInjector` dumps before each failure it
injects (reason `fault_injector:<spec>`), the SIGKILL form included:
that record is the only artifact a killed process leaves by choice.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback

from . import http as _http
from . import trace as _trace

_seq = itertools.count(1)
_dump_lock = threading.Lock()


def flight_dir():
    # registered as MXNET_TELEMETRY_FLIGHT_DIR in utils
    return os.environ.get("MXNET_TELEMETRY_FLIGHT_DIR", "").strip()


def enabled():
    return bool(flight_dir())


def flight_record(reason, exc=None, extra=None):
    """The record itself (pure build, no I/O): reason, wall time,
    exception traceback when given, last-N spans, full statusz.
    `extra` is a caller-supplied JSON-able dict attached verbatim under
    "extra"."""
    rec = {
        "reason": reason,
        "pid": os.getpid(),
        "time_unix": time.time(),
        "argv": list(sys.argv),
        "spans": [s.to_dict() for s in _trace.recent_spans()],
        "stats": _http.statusz(),
    }
    if extra is not None:
        rec["extra"] = extra
    if exc is not None:
        rec["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__)),
        }
    return rec


def dump_flight_record(reason, exc=None, path=None, extra=None):
    """Write the record atomically; returns the path. Explicit `path`
    overrides the env dir (programmatic dumps)."""
    if path is None:
        d = flight_dir()
        if not d:
            raise RuntimeError(
                "flight recorder disabled: set MXNET_TELEMETRY_FLIGHT_"
                "DIR or pass path=")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"flight-{os.getpid()}-{next(_seq)}.json")
    with _dump_lock:
        # the lock serializes snapshot capture + rendering (two
        # crashing threads each get a coherent record); the slow part
        # — the disk write — happens OUTSIDE it, so one thread's dump
        # never stalls behind another's fsync-speed I/O
        rec = flight_record(reason, exc=exc, extra=extra)
        payload = json.dumps(rec, default=str)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)  # atomic: never a torn record
    return path


def maybe_dump(reason, exc=None, extra=None):
    """Best-effort dump iff enabled; never raises (called from the
    excepthooks)."""
    if not enabled():
        return None
    try:
        return dump_flight_record(reason, exc=exc, extra=extra)
    except Exception:
        return None


# ------------------------------------------------------------- hooks
_installed = False
_prev_excepthook = None
_prev_threading_hook = None


def _sys_hook(exc_type, exc, tb):
    if exc_type not in (KeyboardInterrupt, SystemExit):
        if exc is not None and exc.__traceback__ is None:
            exc = exc.with_traceback(tb)
        maybe_dump("unhandled_exception", exc=exc)
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _thread_hook(args):
    if args.exc_type not in (KeyboardInterrupt, SystemExit):
        maybe_dump(
            f"unhandled_exception_in_thread:"
            f"{getattr(args.thread, 'name', '?')}",
            exc=args.exc_value)
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


def install():
    """Chain the crash hooks once (idempotent). The hooks are no-ops
    while MXNET_TELEMETRY_FLIGHT_DIR is unset, so installing at import
    costs nothing."""
    global _installed, _prev_excepthook, _prev_threading_hook
    if _installed:
        return
    _installed = True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _sys_hook
    _prev_threading_hook = threading.excepthook
    threading.excepthook = _thread_hook
