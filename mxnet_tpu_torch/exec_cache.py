"""Process-wide bind-plan cache: the counterpart of mxnet_tpu/exec_cache.py.

The JAX package caches the traced jax program of a bind, so that two
executors bound to the same symbol and shapes share one compiled
callable. The port runs eagerly: what a bind builds, and what this
module caches, is the bind's plan (`BindPlan`): the pass pipeline's
optimized graph, the walk order over it, and the node plan that routes
every fusion group to the kernel handle `passes.plan_for` chose for it.
Rebinding, `Executor.reshape` back to a seen shape and a
BucketingModule's bucket revisits then build no plan.

Cache key (`Executor._build`): the reference's (mxnet_tpu/exec_cache.py
:13-18). The optimized graph's structural key, the group2ctx device map,
input/aux shapes and dtypes, grad_req, grad names, the codegen plan's
per-group decisions, the memory-mirror flag and the sharding plan's
digest (None without a plan). Two components are the port's
own: the bind's device (a plan holds kernel handles built for one
device) and its `cast_compute` dtype (a plan holds the fusion kernels of
one compute dtype). Train/eval mode is not in the key: one plan serves
both.

Counters (`cache_stats()`): `hits`, `misses`, `traces` (plan
constructions, = misses), `evictions`, `shared_hits` and
`canonical_collisions` count as the JAX package's do for the same
sequence of binds. `jit_builds` and `graph_replays` count jax.jit
closures and traced replays of a graph body, which an eager walk does
not have: they stay 0, and are kept so the `execCacheStats` view has the
reference's keys.

Knobs:
  MXNET_EXEC_CACHE=0        disable (every bind builds a private plan)
  MXNET_EXEC_CACHE_SIZE=N   LRU bound on retained entries (default 64)
  MXNET_EXEC_CACHE_DIR=path disk tier (exec_cache_disk): persist a
                            record per entry (the optimized graph, the
                            walk order, the fusion decisions, the layout)
                            and the kernel libraries its plan launches,
                            across processes. A fresh process rebinding a
                            seen graph restores the plan with no plan
                            built and no nvcc run; a stale or corrupt
                            entry falls back to a plain bind.

`cache_stats()` merges the disk tier's counters (disk_hits, disk_misses,
disk_stale, ...) once exec_cache_disk has been imported.
"""
from __future__ import annotations

import hashlib
import os
import sys
import threading
from collections import OrderedDict

from .telemetry import register_view as _register_view

_DEFAULT_CAPACITY = 64

_lock = threading.RLock()
_table: "OrderedDict[tuple, BindPlan]" = OrderedDict()
_stats = {
    "hits": 0,          # bind served from the table (or shared_exec)
    "misses": 0,        # bind had to build a new BindPlan
    "traces": 0,        # BindPlan constructions (== misses)
    "evictions": 0,     # entries dropped by the LRU bound
    "shared_hits": 0,   # hits resolved through an explicit shared_exec
    "jit_builds": 0,    # no counterpart (jax.jit closures): always 0
    "graph_replays": 0,  # no counterpart (traced replays): always 0
    "canonical_collisions": 0,  # hits where a distinct build order (a
                        # new raw pre-pass signature) landed on an
                        # existing entry through the pass pipeline
}

# per-entry set of raw (pre-canonicalization) signatures that resolved
# to it; parallel to _table, pruned with it
_raw_sigs: "dict[tuple, set]" = {}


def _enabled():
    return os.environ.get("MXNET_EXEC_CACHE", "1").lower() not in (
        "0", "false", "off")


def capacity():
    try:
        return max(1, int(os.environ.get("MXNET_EXEC_CACHE_SIZE",
                                         _DEFAULT_CAPACITY)))
    except ValueError:
        return _DEFAULT_CAPACITY


def cache_stats():
    """Snapshot of the cache counters plus current size/capacity, with
    the disk tier's counters merged in when exec_cache_disk has been
    touched."""
    with _lock:
        out = dict(_stats)
        out["size"] = len(_table)
        out["capacity"] = capacity()
        out["enabled"] = _enabled()
    disk = sys.modules.get(__package__ + ".exec_cache_disk")
    if disk is not None:
        out.update(disk.counters())
        out["disk_enabled"] = disk.tier_active()
    return out


def reset_stats():
    with _lock:
        for k in _stats:
            _stats[k] = 0
    disk = sys.modules.get(__package__ + ".exec_cache_disk")
    if disk is not None:
        disk.reset_counters()


# live view in the telemetry registry: /statusz and /metrics read the
# same counters dump_profile embeds as `execCacheStats`
_register_view("execCacheStats", cache_stats, prom_prefix="exec_cache")


def clear():
    """Drop all cached plans (live executors keep their references)."""
    with _lock:
        _table.clear()
        _raw_sigs.clear()


def entry_digests():
    """Digests of the live cache entries, in LRU order."""
    with _lock:
        return [e.digest for e in _table.values()]


def count_shared_hit():
    with _lock:
        _stats["hits"] += 1
        _stats["shared_hits"] += 1


def _mark_hit(key, raw_sig):
    """Bookkeeping for a hit; the caller holds _lock."""
    _stats["hits"] += 1
    _table.move_to_end(key)
    if raw_sig is not None:
        seen = _raw_sigs.setdefault(key, set())
        if raw_sig not in seen:
            seen.add(raw_sig)
            if len(seen) > 1:
                _stats["canonical_collisions"] += 1


def lookup_or_build(key, builder, raw_sig=None, canonical_fn=None,
                    disk_meta_fn=None, restore_fn=None, prepare_fn=None):
    """The cached BindPlan for `key`, built with `builder()` and
    LRU-inserted on a miss. `raw_sig` hashes the caller's
    pre-canonicalization graph signature: a hit whose raw_sig that entry
    never saw means two build orders converged on one plan through the
    pass pipeline (`canonical_collisions`). `canonical_fn` (miss only)
    gives the graph's canonical digest, stamped on the entry.

    Disk tier (exec_cache_disk, active when MXNET_EXEC_CACHE_DIR or a
    bundle overlay is mounted): an in-memory miss probes the disk for a
    record under the entry's digest. `restore_fn(record)` rebuilds the
    plan from a compatible record (None when it cannot: another layout,
    a library blob that fails its check, counted `disk_stale`); a
    restored plan is a miss but not a trace. Otherwise `prepare_fn()`
    (the bind's kernel builds) runs, then `builder()` under the lock,
    and the entry's record, `disk_meta_fn(entry)`'s metadata and
    library blobs, is written for the next process. All disk I/O and kernel
    builds happen outside _lock."""
    with _lock:
        if _enabled():
            entry = _table.get(key)
            if entry is not None:
                _mark_hit(key, raw_sig)
                return entry
    digest = hashlib.sha1(repr(key).encode()).hexdigest()[:12]
    disk = disk_rec = restored = None
    try:
        from . import exec_cache_disk as _disk

        if _disk.tier_active():
            disk = _disk
            disk_rec = disk.lookup_record(digest)
    except Exception:
        disk = None
    if disk_rec is not None and restore_fn is not None:
        restored = restore_fn(disk_rec)
        if restored is None:
            disk.note_stale()
    if restored is None and prepare_fn is not None:
        prepare_fn()
    with _lock:
        if _enabled():
            entry = _table.get(key)
            if entry is not None:  # raced a concurrent builder
                _mark_hit(key, raw_sig)
                return entry
        _stats["misses"] += 1
        if restored is None:
            _stats["traces"] += 1
            entry = builder()
        else:
            entry = restored
        entry.digest = digest
        if canonical_fn is not None:
            try:
                entry.canonical = canonical_fn()
            except Exception:
                entry.canonical = None
        if _enabled():
            _table[key] = entry
            if raw_sig is not None:
                _raw_sigs[key] = {raw_sig}
            cap = capacity()
            while len(_table) > cap:
                old_key, _ = _table.popitem(last=False)
                _raw_sigs.pop(old_key, None)
                _stats["evictions"] += 1
    if disk is not None and restored is None:
        try:
            blobs = entry.codegen_plan.libraries()
        except Exception:
            blobs = ()
        disk.write_record(
            digest, canonical=entry.canonical, blobs=blobs,
            meta_fn=(lambda: disk_meta_fn(entry)) if disk_meta_fn else None)
    entry.from_disk = restored is not None
    return entry


class BindPlan:
    """One bind's plan, shared by every executor whose bind signature
    matches: the optimized symbol, its codegen plan, the node plan of
    the walk (one tuple per computed node, fused groups routed to their
    kernel handle), the variable names by node id, and the head keys."""

    __slots__ = ("opt_symbol", "codegen_plan", "plan", "var_names",
                 "heads", "digest", "canonical", "from_disk", "walk")

    def __init__(self, opt_symbol, codegen_plan, plan, var_names, heads):
        self.opt_symbol = opt_symbol
        self.codegen_plan = codegen_plan
        self.plan = plan
        self.var_names = var_names
        self.heads = heads
        self.digest = None     # entry id (lookup_or_build stamps it)
        self.canonical = None  # canonical graph digest
        self.from_disk = False  # restored from the disk tier
        self.walk = None        # [[node index, name]] of the plan's nodes
