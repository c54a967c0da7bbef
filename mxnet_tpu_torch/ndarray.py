"""NDArray: a device tensor handle, the subset Module, Executor, custom-op
bodies and checkpoints use.

`NDArray` wraps one torch.Tensor (`_data`) and mutates it in place:
`arr[:] = value` and `copyto` write into the existing storage, so the
Executor's argument arrays, the Module's parameter arrays and the
optimizer's updates all see one buffer. Arithmetic with scalars and
arrays (`+ - * /`, reflected and in place) serves CustomOp bodies.

`save`/`load` write and read the JAX package's container format
(mxnet_tpu/ndarray.py, after the reference's src/ndarray/ndarray.cc
Save/Load): the same arrays under the same names give the same bytes.
Each array carries its context's (device type, id): cpu(0) writes
(1, 0) as the JAX package's host arrays do, gpu(i) writes (2, i), the
reference MXNet's GPU code. `load` ignores the field and returns host
arrays, so either package reads either's files.

The imperative op namespace (`mx.nd.<op>`) waits for a later slice.
"""
from __future__ import annotations

import io
import struct

import numpy as np
import torch

from .base import MXNetError
from .context import Context, as_context, cpu, current_context
from .ops.shape_infer import numpy_dtype, torch_dtype


def _resolve(ctx):
    ctx = current_context() if ctx is None else as_context(ctx)
    return ctx, ctx.torch_device()


class NDArray:
    """Mutable n-d array on one device."""

    __slots__ = ("_data", "_ctx")

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        self._data = data
        self._ctx = as_context(data.device) if ctx is None \
            else as_context(ctx)

    # -------------------------------------------------------- properties
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def data(self):
        """The underlying torch.Tensor."""
        return self._data

    # -------------------------------------------------------- conversion
    def asnumpy(self):
        """A host copy (never a view of a host tensor's storage)."""
        t = self._data.detach()
        return t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(dtype)), ctx=self._ctx)

    def copy(self):
        return NDArray(self._data.clone(), ctx=self._ctx)

    def copyto(self, other):
        """Copy into `other` (an NDArray, written in place) or onto a
        Context (a new array)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError(
                    f"copyto: shape {self.shape} != {other.shape}")
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        ctx = as_context(other)
        return NDArray(self._data.to(ctx.torch_device(), copy=True),
                       ctx=ctx)

    def _set_data(self, value):
        """Write `value` (a tensor of this shape) into the storage."""
        with torch.no_grad():
            self._data.copy_(value)

    # -------------------------------------------------------- indexing
    def __getitem__(self, key):
        return NDArray(self._data[key], ctx=self._ctx)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        with torch.no_grad():
            self._data[key] = value.to(self._data.device,
                                       self._data.dtype)

    def __len__(self):
        return self.shape[0]

    # -------------------------------------------------------- arithmetic
    def _operand(self, other):
        if isinstance(other, NDArray):
            return other._data
        if isinstance(other, (int, float, bool)):
            return other
        return torch.as_tensor(np.asarray(other), device=self._data.device)

    def _binary(self, fn, other):
        return NDArray(fn(self._data, self._operand(other)), ctx=self._ctx)

    def _inplace(self, fn, other):
        with torch.no_grad():
            fn(self._data, self._operand(other))
        return self

    def __add__(self, other):
        return self._binary(torch.add, other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(torch.sub, other)

    def __rsub__(self, other):
        return self._binary(lambda a, b: b - a, other)

    def __mul__(self, other):
        return self._binary(torch.mul, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(torch.div, other)

    def __rtruediv__(self, other):
        return self._binary(lambda a, b: b / a, other)

    def __neg__(self):
        return NDArray(-self._data, ctx=self._ctx)

    def __iadd__(self, other):
        return self._inplace(torch.Tensor.add_, other)

    def __isub__(self, other):
        return self._inplace(torch.Tensor.sub_, other)

    def __imul__(self, other):
        return self._inplace(torch.Tensor.mul_, other)

    def __itruediv__(self, other):
        return self._inplace(torch.Tensor.div_, other)

    def __repr__(self):
        return f"<NDArray {self.shape} @{self._ctx}>"


def array(source, ctx=None, dtype=None):
    """An NDArray holding a copy of `source` (numpy, list, tensor or
    NDArray); on the host unless `ctx` names a device."""
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach()
    else:
        src = np.asarray(source)
        if dtype is None and src.dtype == np.float64:
            src = src.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(src))
    ctx = cpu() if ctx is None else as_context(ctx)
    dev = ctx.torch_device()
    t = t.to(dev, torch_dtype(dtype) if dtype is not None else t.dtype,
             copy=True)
    return NDArray(t, ctx=ctx)


def zeros(shape, ctx=None, dtype=np.float32):
    ctx, dev = _resolve(ctx)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=dev), ctx=ctx)


def empty(shape, ctx=None, dtype=np.float32):
    ctx, dev = _resolve(ctx)
    return NDArray(torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                               device=dev), ctx=ctx)


def onehot_encode(indices, out):
    """Write the one-hot rows of `indices` into `out` (N, depth); an
    index outside [0, depth) gives a zero row."""
    depth = out.shape[1]
    idx = indices._data.to(out._data.device, torch.int64)
    ids = torch.arange(depth, device=idx.device)
    out._set_data((idx[:, None] == ids).to(out._data.dtype))
    return out


def waitall():
    """Wait for all work queued on the CUDA devices."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ----------------------------------------------------------- save / load
_FILE_MAGIC = 0x112      # kMXAPINDArrayListMagic (src/c_api/c_api.cc)
_ND_MAGIC = 0xF993FAC9   # NDArray binary chunk magic
_DTYPE_TO_ID = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
                torch.uint8: 3, torch.int32: 4, torch.int8: 5,
                torch.int64: 6, torch.bfloat16: 7}
_ID_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ID.items()}


def _raw_bytes(t):
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save(fname, data):
    """Save an NDArray, a list of them or a dict of named ones in the
    container format (magic, reserved, arrays, names)."""
    if isinstance(data, NDArray):
        data, keys = [data], []
    elif isinstance(data, dict):
        keys = list(data.keys())
        data = list(data.values())
    else:
        keys = []
        data = list(data)
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _FILE_MAGIC, 0))
        f.write(struct.pack("<Q", len(data)))
        for arr in data:
            t = arr._data
            if t.dtype not in _DTYPE_TO_ID:
                raise MXNetError(f"save: unsupported dtype {t.dtype}")
            f.write(struct.pack("<I", _ND_MAGIC))
            f.write(struct.pack("<I", t.ndim))
            f.write(struct.pack(f"<{t.ndim}q", *t.shape))
            f.write(struct.pack("<ii", arr.context.device_typeid,
                                arr.context.device_id))
            f.write(struct.pack("<i", _DTYPE_TO_ID[t.dtype]))
            raw = _raw_bytes(t)
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
        f.write(struct.pack("<Q", len(keys)))
        for k in keys:
            kb = k.encode("utf-8")
            f.write(struct.pack("<Q", len(kb)))
            f.write(kb)


def _load_stream(f, what):
    """The arrays of a container read from the binary stream `f`, on
    the host: a dict when the container names them, else a list."""
    magic, _ = struct.unpack("<QQ", f.read(16))
    if magic != _FILE_MAGIC:
        raise MXNetError(f"invalid NDArray file {what}")
    (n,) = struct.unpack("<Q", f.read(8))
    arrays = []
    for _ in range(n):
        (nd_magic,) = struct.unpack("<I", f.read(4))
        if nd_magic != _ND_MAGIC:
            raise MXNetError("corrupt NDArray chunk")
        (ndim,) = struct.unpack("<I", f.read(4))
        shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
        f.read(8)   # device type and id: loaded to the host
        (dtid,) = struct.unpack("<i", f.read(4))
        if dtid not in _ID_TO_DTYPE:
            raise MXNetError(f"unknown dtype id {dtid} in {what}")
        (nbytes,) = struct.unpack("<Q", f.read(8))
        raw = bytearray(f.read(nbytes))
        dtype = _ID_TO_DTYPE[dtid]
        if not nbytes:
            t = torch.empty(0, dtype=dtype)
        elif dtype == torch.bfloat16:
            t = torch.frombuffer(raw, dtype=torch.int16).view(dtype)
        else:
            t = torch.frombuffer(raw, dtype=dtype)
        arrays.append(NDArray(t.reshape(shape), ctx=cpu()))
    (nk,) = struct.unpack("<Q", f.read(8))
    keys = []
    for _ in range(nk):
        (klen,) = struct.unpack("<Q", f.read(8))
        keys.append(f.read(klen).decode("utf-8"))
    if keys:
        return dict(zip(keys, arrays))
    return arrays


def load(fname):
    """The arrays of a container file, on the host: a dict when the
    file names them, else a list."""
    with open(fname, "rb") as f:
        return _load_stream(f, repr(fname))


def load_frombuffer(buf):
    """Load NDArrays from an in-memory container."""
    return _load_stream(io.BytesIO(buf), "buffer")


__all__ = ["Context", "NDArray", "array", "empty", "load", "load_frombuffer",
           "onehot_encode", "save", "waitall", "zeros"]
