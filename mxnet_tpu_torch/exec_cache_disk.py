"""Disk tier under the in-process bind-plan cache: warm restarts
(mxnet_tpu/exec_cache_disk.py).

The in-process cache (`exec_cache`) shares bind plans within one
process; every restart still pays each bind's plan and the nvcc runs of
its generated fusion kernels. This module is the tier below it: a
directory of per-entry records keyed by the same cache-key digest. A
fresh process that binds a seen graph finds the record, rebuilds the
plan from it and loads the plan's kernel libraries from the record's
blobs: no plan built (`traces` stays 0), no nvcc started.

    <root>/entries/<digest>/record.json
        the optimized graph (Symbol.tojson), the input signatures, the
        layout the plan was built for (device, sharding digest, compute
        dtype), the fusion decisions, the walk order, the libraries the
        plan launches, and the environment fingerprint
    <root>/entries/<digest>/exe-<kind>-<sighash>.bin
        a built shared library, loaded in place with ctypes (`kind` is
        its library name or generated tag, `sighash` the digest in its
        file name under `_build/`)
    <root>/entries/<digest>/exe-<kind>-<sighash>.json
        the blob's metadata: the environment fingerprint, the sha256
        and size of the blob's bytes, the nvcc release it came from

The environment fingerprint (`env_fingerprint`) holds the record
format, the package's name and version, the torch version,
`torch.version.cuda`, and the device kind and compute capability
("cpu" without a card). A record or blob whose fingerprint differs in
any field is counted `disk_stale` and falls back to a plain bind, never
to an error. The JAX package's `xla/` subtree (jax's own persistent
compilation cache) has no counterpart: `_build/` already keys built
libraries by digest across processes.

Activation: set MXNET_EXEC_CACHE_DIR (registered in `utils`). Unset
(the default) the tier is inert. Serving bundles (`serving.bundle`)
mount their embedded `exec_cache/` subtree as a read-only OVERLAY root:
lookups consult the primary dir first, then the overlays; writes go to
the primary dir only (or nowhere when only overlays are mounted).

Robustness, as the JAX package's:

  * a corrupt record, or a blob whose metadata is missing or whose
    bytes do not hash to it, is QUARANTINED (moved aside into
    `<root>/quarantine/`), counted, and treated as a miss: a blob that
    fails its check is never loaded;
  * entries this process wrote are skipped on lookup, so in-process
    plan accounting is identical to the no-disk-tier world;
  * the primary dir is LRU-evicted (whole entries, record mtime as
    recency) to MXNET_EXEC_CACHE_DISK_BYTES.

All counters live under one module lock; all file I/O happens outside
it (the snapshot rule of utils.persist).
"""
from __future__ import annotations

import glob
import hashlib
import os
import re
import shutil
import threading

from .utils.persist import atomic_write_json, read_json

#: record.json / blob format: bump on an incompatible layout change
RECORD_VERSION = 1

_lock = threading.Lock()
_stats = {
    "disk_hits": 0,        # record found on disk and compatible
    "disk_misses": 0,      # no record anywhere (tier active)
    "disk_stale": 0,       # record/blob from another environment or layout
    "disk_writes": 0,      # records written by this process
    "disk_evictions": 0,   # whole entries LRU-evicted over the cap
    "disk_quarantined": 0,  # corrupt records/blobs moved aside
    "exe_loads": 0,        # library blobs verified for loading
    "exe_stores": 0,       # library blobs written
}
#: absolute paths written by THIS process: lookups skip them, so the
#: in-process cache keeps its exact accounting
_self_written = set()
#: read-only bundle roots consulted after the primary dir
_overlays = []
_fingerprint = None


# --------------------------------------------------------------- paths
def cache_dir():
    """Primary (writable) cache root from MXNET_EXEC_CACHE_DIR, or None
    when the tier is unset."""
    raw = os.environ.get("MXNET_EXEC_CACHE_DIR", "")
    return os.path.expanduser(raw) if raw else None


def tier_active():
    """True when any root (primary or overlay) is mounted."""
    return bool(cache_dir()) or bool(_overlays)


def _roots():
    """Search order: primary first (fresh writes win), then overlays."""
    primary = cache_dir()
    roots = [primary] if primary else []
    with _lock:
        roots.extend(_overlays)
    return roots


def entry_dir(root, digest):
    return os.path.join(root, "entries", str(digest))


def add_overlay(path):
    """Mount a read-only exec-cache root (a bundle's `exec_cache/`
    subtree). Idempotent; overlays are searched after the primary."""
    path = os.path.abspath(path)
    with _lock:
        if path not in _overlays:
            _overlays.append(path)


def remove_overlay(path):
    path = os.path.abspath(path)
    with _lock:
        if path in _overlays:
            _overlays.remove(path)


def clear_overlays():
    with _lock:
        _overlays.clear()


# --------------------------------------------------------- fingerprint
def env_fingerprint():
    """What must match for a disk entry to be trusted: the record
    format, the package and its version, torch and its CUDA, and the
    card a library blob runs on (module docstring)."""
    global _fingerprint
    if _fingerprint is None:
        import torch

        from . import __version__

        kind, capability = "cpu", None
        if torch.cuda.is_available():
            idx = torch.cuda.current_device()
            kind = torch.cuda.get_device_name(idx)
            capability = "%d.%d" % torch.cuda.get_device_capability(idx)
        _fingerprint = {
            "format": RECORD_VERSION,
            "framework": "mxnet_tpu_torch",
            "framework_version": __version__,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": kind,
            "capability": capability,
        }
    return dict(_fingerprint)


def _compatible(env):
    """Every field of the fingerprint equal, and no other field: the JAX
    package's records (which carry jaxlib's) are stale here."""
    return isinstance(env, dict) and env == env_fingerprint()


def note_stale():
    """Count a record this process found but cannot use (another layout,
    a blob that failed its check): the caller builds as on a miss."""
    with _lock:
        _stats["disk_stale"] += 1


# ---------------------------------------------------------- quarantine
def _quarantine(root, *paths):
    """Move corrupt files aside: never delete evidence, never raise.
    Counted once per call; quarantined entries read as misses."""
    qdir = os.path.join(root, "quarantine")
    for path in paths:
        if not os.path.exists(path):
            continue
        try:
            os.makedirs(qdir, exist_ok=True)
            os.replace(path, os.path.join(qdir, os.path.basename(path)
                                          + f".{os.getpid()}"))
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass
    with _lock:
        _stats["disk_quarantined"] += 1


# -------------------------------------------------------------- records
def lookup_record(digest):
    """The record dict for `digest` from the first root that has a
    compatible one, else None. Counts disk_hits / disk_misses /
    disk_stale; corrupt records are quarantined and skipped."""
    if not tier_active():
        return None
    stale_seen = False
    for root in _roots():
        path = os.path.join(entry_dir(root, digest), "record.json")
        if path in _self_written or not os.path.exists(path):
            continue
        rec = read_json(path)
        if not isinstance(rec, dict):
            _quarantine(root, path)
            continue
        if not _compatible(rec.get("env")):
            stale_seen = True
            continue
        try:  # LRU recency for the eviction walk
            os.utime(path)
        except OSError:
            pass
        with _lock:
            _stats["disk_hits"] += 1
        return rec
    with _lock:
        if stale_seen:
            _stats["disk_stale"] += 1
        else:
            _stats["disk_misses"] += 1
    return None


def write_record(digest, canonical=None, meta_fn=None, root=None,
                 blobs=()):
    """Persist the record of a freshly built entry into the primary root
    (overlays are read-only), after its library `blobs` ((kind,
    sighash, built library path) each). Best-effort: a full disk or a
    read-only root costs only the next process a plain bind.

    `root` overrides the destination (serving.bundle writes a bundle's
    self-contained `exec_cache/` subtree); explicit-root writes are not
    marked self-written: a bundle is a namespace of its own that the
    writing process may mount and read back."""
    explicit = root is not None
    root = root or cache_dir()
    if not root:
        return None
    for kind, sighash, lib in blobs:
        if store_executable(digest, kind, sighash, lib,
                            root=root if explicit else None) is None:
            return None   # a record never names a blob it lacks
    rec = {"digest": str(digest), "env": env_fingerprint()}
    if canonical:
        rec["canonical"] = canonical
    if meta_fn is not None:
        try:
            meta = meta_fn()
            if meta:
                rec.update(meta)
        except Exception:
            pass  # meta is advisory; the record still marks the entry
    path = os.path.join(entry_dir(root, digest), "record.json")
    try:
        atomic_write_json(path, rec)
    except OSError:
        return None
    with _lock:
        if not explicit:
            _self_written.add(path)
        _stats["disk_writes"] += 1
    if not explicit:
        _maybe_evict()
    return path


# ---------------------------------------------------------- executables
def _safe_kind(kind):
    return re.sub(r"[^A-Za-z0-9_.@-]", "_", str(kind))


def sig_hash(sig_key):
    """Deterministic cross-process hash of a signature key (its repr)."""
    return hashlib.sha1(repr(sig_key).encode()).hexdigest()[:16]


def exe_path(root, digest, kind, sighash):
    """Where the library blob of (entry, kind, sighash) lives."""
    return os.path.join(entry_dir(root, digest),
                        f"exe-{_safe_kind(kind)}-{sighash}.bin")


def _meta_path(blob):
    return os.path.splitext(blob)[0] + ".json"


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def store_executable(digest, kind, sighash, compiled, root=None):
    """Copy the built library at path `compiled` into the primary root
    (or an explicit `root`: the serving.bundle path, not self-marked,
    not evicted) with its metadata. Returns the blob's path, or None
    (tier unset, disk full): soft failures."""
    explicit = root is not None
    root = root or cache_dir()
    if not root:
        return None
    from . import kernels as _kernels

    path = exe_path(root, digest, kind, sighash)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shutil.copyfile(compiled, tmp)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        meta = {"env": env_fingerprint(), "sha256": _sha256(tmp),
                "bytes": os.path.getsize(tmp),
                "library": os.path.basename(compiled),
                "nvcc": _kernels.nvcc_release()}
        os.replace(tmp, path)
        atomic_write_json(_meta_path(path), meta)
    except OSError:
        for p in (tmp, path):
            try:
                os.unlink(p)
            except OSError:
                pass
        return None
    with _lock:
        if not explicit:
            _self_written.add(path)
        _stats["exe_stores"] += 1
    return path


def _verified(root, path):
    """`path` when its metadata is readable, of this environment, and
    the blob hashes to it; None otherwise (quarantined when corrupt,
    counted stale when of another environment)."""
    meta = read_json(_meta_path(path))
    try:
        if not isinstance(meta, dict) or "sha256" not in meta:
            raise ValueError("no blob metadata")
        if not _compatible(meta.get("env")):
            with _lock:
                _stats["disk_stale"] += 1
            return None
        if (os.path.getsize(path) != meta.get("bytes")
                or _sha256(path) != meta["sha256"]):
            raise ValueError("blob bytes do not match their metadata")
    except (OSError, ValueError):
        _quarantine(root, path, _meta_path(path))
        return None
    with _lock:
        _stats["exe_loads"] += 1
    return path


def load_executable(digest, kind, sighash):
    """The path of entry `digest`'s verified library blob of (kind,
    sighash) from the first root that has one, which `kernels` loads in
    place with ctypes; None on a miss, a stale or a corrupt blob (the
    caller builds as on a miss)."""
    if not tier_active():
        return None
    for root in _roots():
        path = exe_path(root, digest, kind, sighash)
        if path in _self_written or not os.path.exists(path):
            continue
        found = _verified(root, path)
        if found is not None:
            try:
                os.utime(os.path.join(entry_dir(root, digest),
                                      "record.json"))
            except OSError:
                pass
            return found
    return None


def find_executable(kind, sighash):
    """The verified blob of library (kind, sighash) under any entry of
    any root, or None: libraries are named by the digest of their
    source, headers and flags, so any entry's copy is the same one
    (`kernels` asks before it starts an nvcc)."""
    if not tier_active():
        return None
    name = f"exe-{_safe_kind(kind)}-{sighash}.bin"
    for root in _roots():
        for path in sorted(glob.glob(os.path.join(
                glob.escape(root), "entries", "*", name))):
            if path in _self_written:
                continue
            found = _verified(root, path)
            if found is not None:
                return found
    return None


# ------------------------------------------------------------- eviction
def disk_cap_bytes():
    from .utils import getenv

    try:
        return int(getenv("MXNET_EXEC_CACHE_DISK_BYTES"))
    except Exception:
        return 0


def _entry_sizes(root):
    """[(mtime, bytes, path)] per entry dir under `root`."""
    base = os.path.join(root, "entries")
    out = []
    try:
        names = os.listdir(base)
    except OSError:
        return out
    for name in names:
        d = os.path.join(base, name)
        if not os.path.isdir(d):
            continue
        size = 0
        try:
            for fn in os.listdir(d):
                try:
                    size += os.path.getsize(os.path.join(d, fn))
                except OSError:
                    pass
            mtime = os.path.getmtime(os.path.join(d, "record.json"))
        except OSError:
            mtime = 0.0
        out.append((mtime, size, d))
    return out


def _maybe_evict():
    """Drop least-recently-used whole entries until the primary root's
    entries/ subtree fits MXNET_EXEC_CACHE_DISK_BYTES (0 = uncapped)."""
    cap = disk_cap_bytes()
    root = cache_dir()
    if not root or cap <= 0:
        return
    entries = _entry_sizes(root)
    total = sum(size for _, size, _ in entries)
    if total <= cap:
        return
    evicted = 0
    for _, size, d in sorted(entries):
        if total <= cap:
            break
        shutil.rmtree(d, ignore_errors=True)
        total -= size
        evicted += 1
    if evicted:
        with _lock:
            _stats["disk_evictions"] += evicted


# ------------------------------------------------------------- counters
def counters():
    with _lock:
        return dict(_stats)


def reset_counters():
    """Zero the counters. `_self_written` is not cleared: it is the
    process's identity of what it wrote, and clearing it would let tests
    that reset stats start reading their own writes back."""
    with _lock:
        for k in _stats:
            _stats[k] = 0


def disk_stats():
    """Telemetry view: all-numeric so the Prometheus flattening emits
    every field; empty while the tier never activated."""
    snap = counters()
    active = tier_active()
    if not active and not any(snap.values()):
        return {}
    snap["enabled"] = bool(active)
    with _lock:
        snap["overlays"] = len(_overlays)
    snap["cap_bytes"] = disk_cap_bytes()
    return snap


def _register_view():
    try:
        from .telemetry import register_view

        register_view("diskCacheStats", disk_stats,
                      prom_prefix="disk_cache", omit_empty=True)
    except Exception:  # pragma: no cover - telemetry is optional
        pass


_register_view()
