"""Serving bundles: one directory artifact = one warm model
(mxnet_tpu/serving/bundle.py).

`ModelRegistry.load(...)` + `warmup()` pays every bind's plan and the
nvcc runs of its generated fusion kernels on every process start (a
decoder: the load of its kernel library and its graph captures). A
bundle snapshots what the warm process built into one atomic directory,
so the next process restores with no plan built and no nvcc run
(execCacheStats / deviceStats / `kernels.nvcc_runs()` show it):

    bundle/
      manifest.json     format, kind, env fingerprint, grids, hashes
      params.npz        the parameter set (content-hashed), the JAX
                        package's names: arg:/aux: for a served model,
                        the decoder's flat names for a decoded one
      symbol.json       the bound graph (kind "served" only)
      exec_cache/       a self-contained exec_cache_disk subtree:
        entries/<digest>/record.json + exe-<kind>-<sighash>.bin/.json

Restore (`load_bundle`) mounts `exec_cache/` as a read-only OVERLAY in
`exec_cache_disk` and replays the ordinary load path: every bind finds
its record (no plan built, `disk_hits`), every kernel library loads in
place from its blob (no nvcc). Warmup still runs its per-bucket
forwards (readiness and calibration); a decoder captures its CUDA
graphs again, since a graph cannot be serialized.

Integrity and compatibility, as the JAX package's:

  * `manifest.params.content_hash` is sha256 over the ARRAY BYTES
    (sorted (name, dtype, shape, data)), not the npz file: the same
    weights give the same hash in both packages. MXNET_BUNDLE_VERIFY=1
    (default) checks it on load; a mismatch always raises BundleError.
  * the env fingerprint (exec_cache_disk's) gates the overlay only: an
    incompatible bundle still loads, building its plans and kernels as
    a plain `load` does, unless MXNET_BUNDLE_STRICT=1 turns that into a
    BundleError.
  * `quantize="int8"` (MXNET_BUNDLE_QUANTIZE) stores the weights int8
    with per-channel scales (serving/quant.py); a manifest and stored
    arrays that disagree about precision are refused unless
    MXNET_BUNDLE_QUANTIZE_OVERRIDE=1. Restore dequantizes on load.

Tuner and calibration records ride along in the manifest and are seeded
into the local stores on load.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import shutil

import numpy as np

from .. import exec_cache_disk as _disk
from ..utils import getenv
from ..utils.persist import atomic_write_json, read_json
from . import quant as _squant
from .batcher import ServingError

log = logging.getLogger(__name__)

#: bundle directory layout version: bump on an incompatible change
BUNDLE_FORMAT = 1

MANIFEST = "manifest.json"
PARAMS = "params.npz"
SYMBOL = "symbol.json"
EXEC_CACHE = "exec_cache"


class BundleError(ServingError):
    """A bundle cannot be written or trusted: target exists, manifest
    missing/corrupt, param content-hash mismatch, or (strict mode) an
    env-incompatible artifact."""


# ------------------------------------------------------------- hashing
def param_content_hash(params):
    """sha256 over the sorted array CONTENT: stable across npz re-zips,
    sensitive to any byte of any parameter."""
    h = hashlib.sha256()
    for name in sorted(params):
        arr = np.ascontiguousarray(_as_numpy(params[name]))
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(tuple(arr.shape)).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _as_numpy(v):
    if hasattr(v, "asnumpy"):  # NDArray
        return v.asnumpy()
    if hasattr(v, "detach"):   # torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)


# ------------------------------------------------------ program harvest
def _program(exec_root, digest, kind, path, sighash=None):
    return {"digest": digest, "kind": kind, "sighash": sighash,
            "file": os.path.relpath(path, os.path.dirname(exec_root))}


def _write_entry(exec_root, digest, canonical, meta_fn, blobs):
    """One record and its library blobs into the bundle's subtree; the
    manifest's program entries for them."""
    path = _disk.write_record(digest, canonical=canonical,
                              meta_fn=meta_fn, root=exec_root,
                              blobs=blobs)
    if path is None:
        raise BundleError(f"bundle write failed for entry {digest}")
    programs = [_program(exec_root, digest, "record", path)]
    for kind, sighash, _ in blobs:
        programs.append(_program(
            exec_root, digest, kind,
            _disk.exe_path(exec_root, digest, kind, sighash), sighash))
    return programs


def _served_payload(model, exec_root):
    """Harvest a warm ServedModel: symbol, params, one record per bind
    plan with the libraries it launches."""
    preds, seen = [], set()
    for pred in [model._base, *model._by_bucket.values()]:
        if id(pred) not in seen:
            seen.add(id(pred))
            preds.append(pred)
    programs, digests = [], []
    for pred in preds:
        compiled = getattr(pred._exec, "_compiled", None)
        if compiled is None or compiled.digest in digests:
            continue
        digests.append(compiled.digest)
        programs += _write_entry(
            exec_root, compiled.digest, compiled.canonical,
            lambda e=pred._exec, c=compiled: e._disk_record_meta(c),
            compiled.codegen_plan.libraries())
    spec = model.spec
    base = model._base
    params = {f"arg:{k}": _as_numpy(v)
              for k, v in base._arg_params.items()}
    params.update({f"aux:{k}": _as_numpy(v)
                   for k, v in base._aux_params.items()})
    manifest = {
        "kind": "served",
        "symbol": SYMBOL,
        "input_specs": {k: list(v)
                        for k, v in spec.input_specs.items()},
        "input_dtypes": {k: str(v)
                         for k, v in base._input_dtypes.items()},
        "batch_buckets": list(spec.batch_buckets),
        "length_buckets": (list(spec.length_buckets)
                           if spec.ragged else None),
        "pad_value": spec.pad_value,
        "digests": digests,
        "canonicals": sorted(
            {c.canonical for p in preds
             for c in [getattr(p._exec, "_compiled", None)]
             if c is not None and c.canonical}),
    }
    # the Predictor applied output_names before storing _symbol: the
    # serialized graph is the final one, restored with output_names=None
    return manifest, params, base._symbol.tojson(), programs


def _decoded_payload(model, exec_root):
    """Harvest a warm DecodedModel: config, params, the engine's record
    with the kernel libraries it loaded."""
    eng = model.engine
    cfg = dataclasses.asdict(model.cfg)
    programs = _write_entry(
        exec_root, eng._digest, None,
        lambda: {"decoder": cfg, "kinds": sorted(eng.trace_counts()),
                 "libraries": [{"kind": k, "sighash": s}
                               for k, s, _ in eng.library_blobs()]},
        eng.library_blobs())
    manifest = {
        "kind": "decoded",
        "decoder": cfg,
        "max_batch": eng.max_batch,
        "page_size": eng.page_size,
        "num_pages": eng.num_pages,
        "page_buckets": list(eng.page_buckets),
        "kernel": eng.kernel_name,
        "ring_prefill": eng.ring_prefill,
        "kv_dtype": eng.kv_dtype,
        # the grid is a function of these too: a restore with other
        # values would capture a grid the saved one does not match
        "prefix_cache": eng.prefix_cache_enabled,
        "merged_step": eng.merged_step_enabled,
        "digests": [eng._digest],
        "decode_kinds": sorted(eng.trace_counts()),
    }
    return manifest, eng.model.flat_params(), None, programs


def _harvest_tuning(canonicals):
    """Tuner choices and calibration evidence for the bundle's graphs:
    the warm process's measured-cost records travel with it."""
    tuner, calib = {}, {}
    try:
        from ..passes.tuner import Autotuner

        table = Autotuner()._load()
        tuner = {k: v for k, v in table.items()
                 if any(k.startswith(f"{c}:") for c in canonicals)}
    except Exception:
        pass
    try:
        from ..profiling import calibration_store

        store = calibration_store()
        for c in canonicals:
            calib.update(store.records(digest=c))
    except Exception:
        pass
    return tuner, calib


# ---------------------------------------------------------------- save
def save_bundle(model, out_dir, quantize=None):
    """Snapshot a WARM model (ServedModel or DecodedModel) into the
    atomic directory artifact `out_dir` (must not exist; built in a
    sibling tmp dir and published by one `os.replace`). Returns
    `out_dir`.

    `quantize="int8"` (default: MXNET_BUNDLE_QUANTIZE) stores the
    parameter set weight-only int8 with per-channel scales
    (serving/quant.py). The content hash covers the STORED (quantized)
    arrays, so verification needs no dequantization pass."""
    from .registry import ServedModel

    if quantize is None:
        quantize = getenv("MXNET_BUNDLE_QUANTIZE") or None
    if quantize and quantize not in _squant.SCHEMES:
        raise BundleError(
            f"unknown bundle quantization {quantize!r} "
            f"(this build writes {_squant.SCHEMES})")
    out_dir = os.path.abspath(out_dir)
    if os.path.exists(out_dir):
        raise BundleError(f"bundle target exists: {out_dir}")
    if isinstance(model, ServedModel):
        warm, payload_fn = model._warm, _served_payload
    else:
        warm = getattr(model.engine, "_warm", False)
        payload_fn = _decoded_payload
    if not warm:
        raise BundleError(
            "bundle a WARM model: call warmup() first — the bundle "
            "snapshots the plans and kernels warmup built")

    tmp = f"{out_dir}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        exec_root = os.path.join(tmp, EXEC_CACHE)
        manifest, params, symbol_json, programs = payload_fn(
            model, exec_root)
        if not programs:
            raise BundleError(
                "no plan or kernel captured: a bundle would not avoid "
                "any build")
        if quantize:
            params, qrecord = _squant.quantize_params(
                params, scheme=quantize)
            manifest["quantization"] = qrecord
        np.savez(os.path.join(tmp, PARAMS), **params)
        if symbol_json is not None:
            with open(os.path.join(tmp, SYMBOL), "w") as f:
                f.write(symbol_json)
        tuner, calib = _harvest_tuning(manifest.get("canonicals", []))
        manifest.update({
            "format": BUNDLE_FORMAT,
            "name": model.name,
            "version": model.version,
            "env": _disk.env_fingerprint(),
            "params": {
                "file": PARAMS,
                "count": len(params),
                "content_hash": param_content_hash(params),
            },
            "programs": programs,
            "tuner": tuner,
            "calibration": calib,
        })
        atomic_write_json(os.path.join(tmp, MANIFEST), manifest)
        os.replace(tmp, out_dir)  # atomic publish
    except BundleError:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    except OSError as e:
        shutil.rmtree(tmp, ignore_errors=True)
        raise BundleError(f"bundle write failed: {e}") from e
    return out_dir


# ---------------------------------------------------------------- load
def read_manifest(path):
    """The bundle's manifest dict; raises BundleError when `path` is
    not a bundle (missing/corrupt/foreign-format manifest)."""
    manifest = read_json(os.path.join(path, MANIFEST))
    if not isinstance(manifest, dict):
        raise BundleError(f"not a bundle (no readable manifest): "
                          f"{path}")
    if manifest.get("format") != BUNDLE_FORMAT:
        raise BundleError(
            f"unsupported bundle format {manifest.get('format')!r} "
            f"(this build reads format {BUNDLE_FORMAT})")
    return manifest


def _load_params(path, manifest):
    rec = manifest.get("params") or {}
    fpath = os.path.join(path, rec.get("file", PARAMS))
    try:
        with np.load(fpath) as z:
            params = {k: z[k] for k in z.files}
    except Exception as e:
        raise BundleError(f"bundle params unreadable: {e}") from e
    if getenv("MXNET_BUNDLE_VERIFY"):
        want = rec.get("content_hash")
        got = param_content_hash(params)
        if want != got:
            raise BundleError(
                f"bundle param content hash mismatch (manifest "
                f"{str(want)[:12]}…, actual {got[:12]}…): refusing "
                f"to serve a tampered or torn artifact")
    return params


def _seed_tuning(manifest):
    """Merge the bundle's tuner/calibration records into the local
    stores (best-effort: both are advisory evidence)."""
    try:
        from ..passes.tuner import Autotuner

        tuner = Autotuner()
        for key, rec in (manifest.get("tuner") or {}).items():
            if isinstance(rec, dict):
                tuner._persist(key, rec)
    except Exception:
        pass
    try:
        from ..profiling import calibration_store

        store = calibration_store()
        for rec in (manifest.get("calibration") or {}).values():
            if isinstance(rec, dict):
                store.record(rec.get("digest"), rec.get("platform"),
                             rec.get("kind"), rec.get("seconds"),
                             meta=rec.get("meta"))
    except Exception:
        pass


def load_bundle(path, registry, name=None, version=None, warmup=True):
    """Restore a bundle into `registry` on the current context (the card
    unless the caller is inside `with mx.cpu():`). Mounts the bundle's
    exec_cache subtree as a read-only overlay (when env-compatible),
    then replays the ordinary load path: binds restore their plans from
    the records, kernel libraries load from the blobs, warmup runs
    every cell.

    An env-incompatible bundle (another torch, CUDA or card) degrades
    to a plain load unless MXNET_BUNDLE_STRICT=1."""
    from ..context import current_context

    path = os.path.abspath(path)
    manifest = read_manifest(path)
    compatible = _disk._compatible(manifest.get("env"))
    if not compatible:
        if getenv("MXNET_BUNDLE_STRICT"):
            raise BundleError(
                f"bundle env {manifest.get('env')} is incompatible "
                f"with this process ({_disk.env_fingerprint()}) and "
                f"MXNET_BUNDLE_STRICT=1")
        log.warning(
            "bundle %s built under %s; this process is %s — loading "
            "without its plans and kernel libraries (plain load)", path,
            manifest.get("env"), _disk.env_fingerprint())
    params = _load_params(path, manifest)
    qrecord = manifest.get("quantization")
    quantized = _squant.is_quantized(params)
    if bool(qrecord) != quantized:
        # the manifest and the stored arrays disagree about precision:
        # a stripped record (or stripped scale planes) silently changes
        # what the model computes, so it is a refusal, not a warning
        if not getenv("MXNET_BUNDLE_QUANTIZE_OVERRIDE"):
            said = ("quantized " + str(qrecord.get("scheme"))
                    if qrecord else "full precision")
            stored = "quantized" if quantized else "full precision"
            raise BundleError(
                f"bundle precision mismatch: manifest says {said}, "
                f"stored params are {stored} — refusing (set "
                f"MXNET_BUNDLE_QUANTIZE_OVERRIDE=1 to load anyway)")
        log.warning("bundle %s precision mismatch overridden "
                    "(MXNET_BUNDLE_QUANTIZE_OVERRIDE=1)", path)
    if qrecord or quantized:
        # dequant-on-load: the restored model computes in float32
        params = _squant.dequantize_params(params, qrecord)
    if compatible:
        _disk.add_overlay(os.path.join(path, EXEC_CACHE))
    _seed_tuning(manifest)
    name = name or manifest["name"]
    version = manifest["version"] if version is None else version
    ctx = current_context()
    if manifest["kind"] == "decoded":
        from ..decoding.model import DecoderConfig

        cfg = DecoderConfig(**manifest["decoder"])
        return registry.load_decoder(
            name, params, cfg, version=version, warmup=warmup,
            max_batch=manifest["max_batch"],
            page_size=manifest["page_size"],
            num_pages=manifest["num_pages"],
            page_buckets=tuple(manifest["page_buckets"]),
            ring_prefill=manifest["ring_prefill"],
            kv_dtype=manifest.get("kv_dtype", "float32"),
            device=ctx,
            **{k: manifest[k] for k in ("prefix_cache", "merged_step")
               if k in manifest})
    with open(os.path.join(path, manifest["symbol"])) as f:
        symbol_json = f.read()
    length_buckets = manifest.get("length_buckets")
    return registry.load(
        name, symbol_json, params,
        {k: tuple(v) for k, v in manifest["input_specs"].items()},
        version=version, ctx=ctx,
        input_dtypes=manifest.get("input_dtypes") or None,
        batch_buckets=tuple(manifest["batch_buckets"]),
        length_buckets=(tuple(length_buckets)
                        if length_buckets else None),
        pad_value=manifest.get("pad_value", 0.0),
        warmup=warmup)
