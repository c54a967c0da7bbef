"""Pass manager (mxnet_tpu/passes/manager.py): the ordered pipeline with
its safety contract. After every pass the manager compacts the graph,
re-checks the structural invariants (`Graph.validate`) and runs the
structural verifier (`Graph.verify`), raising here, naming the pass,
when a rewrite produced an invalid graph.

`optimize_for_bind` is the executor's entry point: behind
`MXNET_GRAPH_PASSES` (default on; "0"/"off" bypasses; a comma list
selects and orders passes) and memoized per (structure key, pipeline),
so rebinding a seen graph costs a lookup.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

from ..base import MXNetError
from . import codegen as _cg
from . import transforms as _t
from .ir import Graph

# name -> (fn, default_on); insertion order is pipeline order
_PASS_REGISTRY: "OrderedDict[str, tuple]" = OrderedDict()


def register_pass(name, fn=None, *, default_on=True):
    """Register a graph pass (`fn(graph) -> n_rewrites`)."""
    def _add(f):
        if name in _PASS_REGISTRY:
            raise MXNetError(f"graph pass {name!r} registered twice")
        _PASS_REGISTRY[name] = (f, default_on)
        return f

    return _add(fn) if fn is not None else _add


def list_passes():
    return list(_PASS_REGISTRY)


register_pass("dce", _t.dce)
register_pass("fold", _t.fold)
register_pass("cse", _t.cse)
register_pass("canonicalize", _t.canonicalize)
register_pass("fusion_hints", _t.fusion_hints)
register_pass("codegen", _cg.codegen)


def default_pipeline():
    return [n for n, (_, on) in _PASS_REGISTRY.items() if on]


# ---------------------------------------------------------------- stats
_STATS_LOCK = threading.Lock()
_PASS_COUNTERS = {
    "dce": "nodes_eliminated", "fold": "folds", "cse": "cse_hits",
    "canonicalize": "canonical_rewrites", "fusion_hints": "fusion_groups",
    "codegen": "fusion_lowered",
}


def _zero_stats():
    out = {"pipeline_runs": 0, "pipeline_cached": 0, "nodes_in": 0,
           "nodes_out": 0, "verify_failures": 0, "pass_time_us": {}}
    out.update({c: 0 for c in _PASS_COUNTERS.values()})
    return out


_stats = _zero_stats()


def graph_pass_stats():
    with _STATS_LOCK:
        out = dict(_stats)
        out["pass_time_us"] = dict(_stats["pass_time_us"])
    return out


def reset_pass_stats():
    global _stats
    with _STATS_LOCK:
        _stats = _zero_stats()


# -------------------------------------------------------------- manager
class PassManager:
    """Runs a pass list over a Graph with per-pass compaction,
    validation and verification."""

    def __init__(self, passes=None, verify=True):
        names = list(passes) if passes is not None else default_pipeline()
        unknown = [n for n in names if n not in _PASS_REGISTRY]
        if unknown:
            raise MXNetError(
                f"unknown graph pass(es) {unknown}; registered: "
                f"{list_passes()} (MXNET_GRAPH_PASSES)")
        self.passes = [(n, _PASS_REGISTRY[n][0]) for n in names]
        self.verify = verify

    def run(self, graph):
        with _STATS_LOCK:
            _stats["pipeline_runs"] += 1
            _stats["nodes_in"] += len(graph)
        for name, fn in self.passes:
            t0 = time.perf_counter()
            applied = int(fn(graph) or 0)
            swept = graph.compact()
            graph.validate()
            issues = graph.verify() if self.verify else []
            with _STATS_LOCK:
                _stats["pass_time_us"][name] = (
                    _stats["pass_time_us"].get(name, 0)
                    + int((time.perf_counter() - t0) * 1e6))
                _stats[_PASS_COUNTERS[name]] += applied
                if name != "dce":
                    _stats["nodes_eliminated"] += swept
                if issues:
                    _stats["verify_failures"] += 1
            if issues:
                raise MXNetError(f"graph pass {name!r} produced an invalid "
                                 f"graph: {'; '.join(issues)}")
        with _STATS_LOCK:
            _stats["nodes_out"] += len(graph)
        return graph


# -------------------------------------------------------- entry points
def pipeline_spec():
    """Parse MXNET_GRAPH_PASSES: None = disabled, else pass-name list."""
    raw = os.environ.get("MXNET_GRAPH_PASSES", "1").strip()
    if raw in ("0", "off", "false", "False", "none"):
        return None
    if raw in ("", "1", "on", "true", "True", "default"):
        return default_pipeline()
    return [p.strip() for p in raw.split(",") if p.strip()]


def optimize(symbol, passes=None, verify=True):
    """Run the pipeline over a Symbol, returning the optimized Symbol."""
    graph = Graph.from_symbol(symbol)
    PassManager(passes, verify=verify).run(graph)
    return graph.to_symbol()


_MEMO_LOCK = threading.Lock()
_memo: "OrderedDict" = OrderedDict()
_MEMO_CAP = 128


def optimize_for_bind(symbol):
    """The MXNET_GRAPH_PASSES pipeline, memoized; `symbol` itself when
    disabled."""
    spec = pipeline_spec()
    if spec is None:
        return symbol
    key = (symbol.structure_key(), tuple(spec))
    with _MEMO_LOCK:
        hit = _memo.get(key)
        if hit is not None:
            _memo.move_to_end(key)
    if hit is not None:
        with _STATS_LOCK:
            _stats["pipeline_cached"] += 1
        return hit
    optimized = optimize(symbol, passes=spec)
    with _MEMO_LOCK:
        _memo[key] = optimized
        while len(_memo) > _MEMO_CAP:
            _memo.popitem(last=False)
    return optimized


def clear_memo():
    with _MEMO_LOCK:
        _memo.clear()
