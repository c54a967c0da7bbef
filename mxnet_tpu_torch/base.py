"""Base error type, automatic names and the parameter coercers.

Coercers turn op parameters given as strings (a Symbol loaded from
JSON) or Python values into the values the ops take, as
dmlc::Parameter does in MXNet.
"""
from __future__ import annotations

import re
import threading


class MXNetError(RuntimeError):
    """Error raised by the framework."""


_name_lock = threading.Lock()
_name_counters: dict[str, int] = {}


def _auto_name(prefix: str) -> str:
    """A unique name like `convolution3` (MXNet's NameManager)."""
    with _name_lock:
        idx = _name_counters.get(prefix, 0)
        _name_counters[prefix] = idx + 1
    return f"{prefix}{idx}"


_TRUE = frozenset(("1", "true", "True", "TRUE"))
_FALSE = frozenset(("0", "false", "False", "FALSE", "none", "None"))


def coerce_bool(v) -> bool:
    if isinstance(v, str):
        if v in _TRUE:
            return True
        if v in _FALSE:
            return False
        raise MXNetError(f"cannot interpret {v!r} as bool")
    return bool(v)


def coerce_int(v) -> int:
    return int(v)


def coerce_float(v) -> float:
    return float(v)


def coerce_tuple(v, n=None, typ=int):
    """Parse '(2, 2)' / '[2,2]' / 2 / (2,2) into a tuple of `typ`."""
    if isinstance(v, str):
        s = v.strip()
        if s.startswith(("(", "[")):
            s = s[1:-1]
        items = [x for x in re.split(r"[,\s]+", s) if x]
        out = tuple(typ(x) for x in items)
    elif isinstance(v, (tuple, list)):
        out = tuple(typ(x) for x in v)
    else:
        out = (typ(v),) if n is None else (typ(v),) * n
    if n is not None and len(out) == 1 and n > 1:
        out = out * n
    if n is not None and len(out) != n:
        raise MXNetError(f"expected tuple of length {n}, got {v!r}")
    return out


def coerce_str(v) -> str:
    return str(v)
