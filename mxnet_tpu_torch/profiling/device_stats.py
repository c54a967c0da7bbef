"""Per-program accounting: capture time, device bytes, flops
(mxnet_tpu/profiling/device_stats.py).

The JAX package records every compiled XLA executable. The port's
counterparts of an executable are the programs it captures or plans
once and then runs many times: the fused train step's CUDA graph and
its k-step replays (`parallel/dp_step.py`), the decode engine's cell
graphs (`decoding/engine.py`) and the exec cache's bind plans
(`executor.py`). Each lands here as a record keyed by (digest, kind):

  compile_s    seconds to capture the graph (a bind plan: to build it,
               passes and fusion kernels included)
  trace_s      seconds of the warmup run before a capture
  temp_bytes   bytes the capture added to the graph's memory pool
               (`torch.cuda.memory_reserved` across the capture)
  arg_bytes    bytes of the program's static inputs and state
  out_bytes    bytes of its static outputs
  hbm_bytes    arg + out + temp
  flops        floating-point operations of one run
               (`torch.utils.flop_counter.FlopCounterMode`)
  graphed      True for a captured graph; False, with `uncaptured_op`
               naming the op, for a fused step that runs uncaptured
               because an op of its graph must synchronise with the host

A bind plan restored from the exec cache's disk tier
(`record_program(..., from_disk=True)`) is not a compile: it bills
`totals.disk_loads` and the record's `disk_loads` instead of
`totals.compiles`, as the JAX package's executables restored AOT do.

Several signatures of one family merge: seconds add up, byte and flop
fields keep the largest. `instrument(fn, digest, kind)` wraps a plain
callable the same way: its first call of each argument signature is
timed and recorded. MXNET_PROFILING=0 records nothing. The
`deviceStats` view keeps the JAX package's keys.
"""
from __future__ import annotations

import os
import threading
import time

from ..telemetry import register_view as _register_view
from ..telemetry import registry as _treg

_DEFAULT_MAX_SIGS = 64

_lock = threading.Lock()
_records: "dict[tuple, dict]" = {}
_totals = {"fallbacks": 0, "compile_errors": 0, "compiles": 0,
           "disk_loads": 0}

_EXECUTABLES = _treg.gauge(
    "mxnet_tpu_profiling_executables",
    "Distinct device executables captured by the profiling layer")
_COMPILE_SECONDS = _treg.counter(
    "mxnet_tpu_profiling_compile_seconds_total",
    "Wall seconds spent in XLA compilation, by program kind")
_HBM_PEAK = _treg.gauge(
    "mxnet_tpu_profiling_executable_hbm_bytes_peak",
    "Largest single-executable HBM footprint (args+outputs+temps+code)")


def profiling_enabled():
    return os.environ.get("MXNET_PROFILING", "1").lower() not in (
        "0", "false", "off")


def _max_sigs():
    try:
        return max(1, int(os.environ.get("MXNET_PROFILING_MAX_SIGS",
                                         _DEFAULT_MAX_SIGS)))
    except ValueError:
        return _DEFAULT_MAX_SIGS


def _platform(device):
    dev = getattr(device, "type", device)
    return "gpu" if dev == "cuda" else (str(dev) if dev else None)


def _new_record(digest, kind, canonical, label):
    return {
        "digest": digest, "kind": kind,
        "canonical": canonical, "label": label,
        "executables": 0,
        "trace_s": 0.0, "compile_s": 0.0,
        "arg_bytes": 0, "out_bytes": 0, "temp_bytes": 0,
        "code_bytes": 0, "alias_bytes": 0, "hbm_bytes": 0,
        "flops": 0.0, "bytes_accessed": 0.0,
        "platform": None,
    }


def record_program(digest, kind, compile_s=0.0, trace_s=0.0,
                   arg_bytes=0, out_bytes=0, temp_bytes=0, flops=0.0,
                   canonical=None, label=None, device=None, graphed=None,
                   uncaptured_op=None, from_disk=False):
    """Merge one captured (or planned) program into the record table
    (module docstring); `from_disk=True` marks a plan restored from the
    disk tier. Returns its hbm bytes."""
    if not digest or not profiling_enabled():
        return 0
    arg_b, out_b, tmp_b = int(arg_bytes), int(out_bytes), int(temp_bytes)
    hbm = arg_b + out_b + tmp_b
    key = (str(digest), str(kind))
    with _lock:
        rec = _records.get(key)
        if rec is None:
            rec = _records[key] = _new_record(str(digest), str(kind),
                                              canonical, label)
        rec["executables"] += 1
        rec["trace_s"] += float(trace_s)
        rec["compile_s"] += float(compile_s)
        for field, val in (("arg_bytes", arg_b), ("out_bytes", out_b),
                           ("temp_bytes", tmp_b), ("hbm_bytes", hbm),
                           ("flops", float(flops))):
            if val > rec[field]:
                rec[field] = val
        if canonical and not rec["canonical"]:
            rec["canonical"] = canonical
        rec["platform"] = _platform(device)
        if graphed is not None:
            rec["graphed"] = bool(graphed)
            rec["uncaptured_op"] = uncaptured_op
        if from_disk:
            _totals["disk_loads"] += 1
            rec["disk_loads"] = rec.get("disk_loads", 0) + 1
        else:
            _totals["compiles"] += 1
        n_records = len(_records)
        peak = max(r["hbm_bytes"] for r in _records.values())
    _COMPILE_SECONDS.inc(float(compile_s), kind=str(kind))
    _EXECUTABLES.set(n_records)
    _HBM_PEAK.set(peak)
    return hbm


def note_fallback(digest=None, kind=None, compile_error=False):
    with _lock:
        _totals["fallbacks"] += 1
        if compile_error:
            _totals["compile_errors"] += 1


def device_stats():
    """Snapshot: {"executables": {"digest:kind": record}, "totals":
    {...}, "preflight": the last pre-flight report (if any)}; {} while
    nothing was recorded."""
    with _lock:
        recs = {f"{d}:{k}": dict(r) for (d, k), r in _records.items()}
        totals = dict(_totals)
    from . import preflight as _pf

    pf = _pf.last_preflight()
    if not recs and pf is None:
        return {}
    totals.update({
        "count": len(recs),
        "compile_s": round(sum(r["compile_s"] for r in recs.values()),
                           6),
        "trace_s": round(sum(r["trace_s"] for r in recs.values()), 6),
        "hbm_peak_bytes": max(
            [r["hbm_bytes"] for r in recs.values()], default=0),
    })
    out = {"executables": recs, "totals": totals}
    if pf is not None:
        out["preflight"] = pf
    return out


def records_for(canonical=None, digest=None, kind=None):
    """Records filtered by canonical digest / family digest / kind."""
    with _lock:
        recs = [dict(r) for r in _records.values()]
    if canonical is not None:
        recs = [r for r in recs if r["canonical"] == canonical]
    if digest is not None:
        recs = [r for r in recs if r["digest"] == digest]
    if kind is not None:
        recs = [r for r in recs if r["kind"] == kind]
    return recs


def reset_device_stats():
    with _lock:
        _records.clear()
        for k in _totals:
            _totals[k] = 0


_register_view("deviceStats", device_stats, prom_prefix="device",
               omit_empty=True)


def tensor_bytes(tensors):
    """Bytes of the tensors in a (nested) list/tuple/dict."""
    if tensors is None:
        return 0
    if isinstance(tensors, dict):
        return sum(tensor_bytes(v) for v in tensors.values())
    if isinstance(tensors, (list, tuple)):
        return sum(tensor_bytes(v) for v in tensors)
    nbytes = getattr(tensors, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


# --------------------------------------------------------- the wrapper
def _sig_key(args, kwargs):
    """Hashable signature of a call: (shape, dtype, device) of tensor
    arguments, type and value of Python scalars."""
    sig = []
    for x in list(args) + [kwargs[k] for k in sorted(kwargs)]:
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            sig.append((tuple(x.shape), str(x.dtype),
                        str(getattr(x, "device", ""))))
        elif isinstance(x, (bool, int, float, complex, str, bytes,
                            type(None))):
            sig.append((type(x).__name__, x))
        else:
            raise TypeError(f"unhashable argument {type(x)}")
    return tuple(sig)


class InstrumentedJit:
    """Accounting wrapper around one callable (module docstring): the
    first call of each signature is timed and recorded, every call
    returns the callable's own result."""

    __slots__ = ("fn", "digest", "kind", "canonical", "label", "_seen",
                 "_lock")

    def __init__(self, fn, digest, kind, canonical=None, label=None):
        self.fn = fn
        self.digest = str(digest)
        self.kind = str(kind)
        self.canonical = canonical
        self.label = label
        self._seen = set()
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        if not profiling_enabled():
            return self.fn(*args, **kwargs)
        try:
            key = _sig_key(args, kwargs)
        except TypeError:
            return self.fn(*args, **kwargs)
        with self._lock:
            first = key not in self._seen and len(self._seen) < _max_sigs()
            if first:
                self._seen.add(key)
        if not first:
            return self.fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        dev = next((getattr(x, "device", None) for x in args
                    if hasattr(x, "device")), None)
        record_program(self.digest, self.kind,
                       compile_s=time.perf_counter() - t0,
                       arg_bytes=tensor_bytes(list(args)),
                       out_bytes=tensor_bytes(out),
                       canonical=self.canonical, label=self.label,
                       device=dev)
        return out

    def __getattr__(self, name):
        return getattr(self.fn, name)


def instrument(fn, digest, kind, canonical=None, label=None):
    """Wrap `fn` for accounting; a falsy digest returns `fn`
    unchanged."""
    if not digest:
        return fn
    return InstrumentedJit(fn, digest, kind, canonical=canonical,
                           label=label)
