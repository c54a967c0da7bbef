"""NDArray: a device tensor handle, the subset Module and Executor use.

`NDArray` wraps one torch.Tensor (`_data`) and mutates it in place:
`arr[:] = value` and `copyto` write into the existing storage, so the
Executor's argument arrays, the Module's parameter arrays and the
optimizer's updates all see one buffer. The imperative op namespace
(`mx.nd.<op>`) waits for a later slice.
"""
from __future__ import annotations

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
        return self._data.detach().cpu().numpy()

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


__all__ = ["Context", "NDArray", "array", "empty", "zeros"]
