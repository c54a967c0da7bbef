"""Weight-only int8 for serving bundles (mxnet_tpu/serving/quant.py):
per-channel symmetric quantization of the parameter set, numpy end to
end, so the stored arrays are the JAX package's bit for bit.

Each float array of two or more dimensions is stored as int8 with a
float32 scale per OUTPUT CHANNEL (last axis): scale = maxabs / 127,
q = round(w / scale). Vectors (norms, biases) and integer arrays pass
through. A bundle's params.npz then shrinks about 4x; restore is
dequant-on-load, so the restored model computes in float32 from the
dequantized weights (the int8 is a disk and transfer saving, not a
resident-memory one).

Storage convention inside the npz: each quantized array `name` is
stored as int8 under its own name, with its float32 scale vector under
`name + SCALE_SUFFIX`. The manifest's `quantization` record lists
exactly which names were quantized, so a stripped scale plane or a
stripped record is detected (`load_bundle`'s precision-mismatch
refusal).
"""
from __future__ import annotations

import numpy as np

#: scale companion key: params.npz stores `w` (int8) + `w__scale__`
SCALE_SUFFIX = "__scale__"

#: quantization schemes this build can write/read
SCHEMES = ("int8",)

_SCALE_FLOOR = 1e-8


def quantizable(arr):
    """Weight-only: quantize float matrices (ndim >= 2). Vectors
    (norms, biases) and integer/bool arrays stay verbatim — they are
    tiny and precision-critical."""
    return (isinstance(arr, np.ndarray) and arr.ndim >= 2
            and arr.dtype.kind == "f")


def quantize_array(arr):
    """(int8 array, float32 per-channel scale over the LAST axis).
    Symmetric: q = round(w / scale), scale = maxabs_channel / 127,
    so dequant is one broadcast multiply and zero is exact."""
    w = np.asarray(arr, dtype=np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    scale = (np.maximum(amax, _SCALE_FLOOR) / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_array(q, scale):
    """Restore float32 from (int8, per-channel scale)."""
    return q.astype(np.float32) * np.asarray(scale, dtype=np.float32)


def quantize_params(params, scheme="int8"):
    """Quantize a whole parameter dict for storage. Returns
    (stored_params, record): `stored_params` holds int8 arrays plus
    their `SCALE_SUFFIX` companions (non-quantizable entries pass
    through untouched); `record` is the manifest's `quantization`
    entry — scheme, axis, and the exact name list, so restore can
    verify nothing was stripped."""
    if scheme not in SCHEMES:
        raise ValueError(
            f"unknown quantization scheme {scheme!r} "
            f"(this build writes {SCHEMES})")
    out, quantized, skipped = {}, [], []
    for name in sorted(params):
        if name.endswith(SCALE_SUFFIX):
            raise ValueError(
                f"parameter name collides with the scale-companion "
                f"convention: {name!r}")
        arr = np.asarray(params[name])
        if quantizable(arr):
            q, scale = quantize_array(arr)
            out[name] = q
            out[name + SCALE_SUFFIX] = scale
            quantized.append(name)
        else:
            out[name] = arr
            skipped.append(name)
    return out, {"scheme": scheme, "axis": -1,
                 "quantized": quantized, "skipped": skipped}


def dequantize_params(stored, record=None):
    """Invert `quantize_params`: rebuild the float32 parameter dict
    from stored int8 + scale companions. With a manifest `record`,
    restores exactly the recorded name list and raises KeyError on a
    missing scale plane (a torn artifact); without one, any int8
    array with a scale companion is dequantized (best effort)."""
    names = ((record or {}).get("quantized")
             if record else
             [n for n in stored
              if not n.endswith(SCALE_SUFFIX)
              and n + SCALE_SUFFIX in stored])
    names = set(names or ())
    out = {}
    for name, arr in stored.items():
        if name.endswith(SCALE_SUFFIX):
            continue
        if name in names:
            out[name] = dequantize_array(arr,
                                         stored[name + SCALE_SUFFIX])
        else:
            out[name] = arr
    return out


def is_quantized(stored):
    """Does this stored parameter dict carry scale companions?"""
    return any(n.endswith(SCALE_SUFFIX) for n in stored)
