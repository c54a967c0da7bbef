"""Exact array transport for the elastic wire protocol
(mxnet_tpu/elastic/codec.py: the same frames and digests, byte for
byte).

The fleet wire speaks JSON (fleet/wire.py) — fine for control frames,
lossy for float payloads if they round-trip through decimal text. The
elastic tier's whole acceptance bar is BITWISE equality of final
params, so arrays ride the JSON frames as base64 of their raw
little-endian bytes: encode/decode is `tobytes()`/`frombuffer()`, no
textual float ever materializes, and a float32 crosses any number of
hops unchanged.
"""
from __future__ import annotations

import base64
import hashlib

import numpy as np


def encode(arr):
    """np.ndarray -> JSON-safe dict (exact byte round-trip)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return {
        "d": base64.b64encode(arr.tobytes()).decode("ascii"),
        "s": list(arr.shape),
        "t": arr.dtype.str if arr.dtype.byteorder != "=" else
             arr.dtype.newbyteorder("<").str,
    }


def decode(obj):
    """Inverse of encode (returns a writable array)."""
    raw = base64.b64decode(obj["d"])
    arr = np.frombuffer(raw, dtype=np.dtype(obj["t"]))
    return arr.reshape(tuple(obj["s"])).copy()


def encode_tree(tree):
    """{name: array} -> {name: encoded}, in sorted name order so the
    serialized frame bytes are identical whichever worker builds
    them (the bit-identity bar covers the wire, not just the
    arrays)."""
    return {k: encode(tree[k]) for k in sorted(tree)}


def decode_tree(tree):
    """{name: encoded} -> {name: array} (sorted for the same
    frame-determinism as encode_tree)."""
    return {k: decode(tree[k]) for k in sorted(tree)}


def payload_bytes(obj):
    """Raw (pre-base64) byte count of one encoded array or a tree of
    them — what elasticStats counts as 'moved'."""
    if "d" in obj and "s" in obj:
        return len(obj["d"]) * 3 // 4
    return sum(payload_bytes(obj[k]) for k in sorted(obj))


def digest(tree):
    """Order-independent content hash of {name: array} — workers put
    this in heartbeats so cross-worker param divergence is a counted
    mismatch, not silent drift."""
    h = hashlib.sha1()
    for name in sorted(tree):
        a = np.ascontiguousarray(tree[name])
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()
