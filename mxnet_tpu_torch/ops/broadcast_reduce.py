"""Reductions: sum, mean, max, min (the fusion pass's REDUCE_OPS) with
MXNet's axis / keepdims / exclude parameters."""
from __future__ import annotations

import torch

from ..base import coerce_bool, coerce_tuple
from .registry import register


def _norm_axis(axis, ndim, exclude=False):
    if axis is None or axis == () or axis == "":
        ax = None
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        keep = set(ax or ())
        ax = tuple(i for i in range(ndim) if i not in keep)
    return ax


_REDUCE_COERCE = {
    "axis": lambda v: None if v in (None, "None", "") else coerce_tuple(v),
    "keepdims": coerce_bool,
    "exclude": coerce_bool,
}


def _reduce(name, fn, aliases=()):
    @register(name, arg_names=["data"], coerce=_REDUCE_COERCE,
              aliases=aliases)
    def _impl(data, axis=None, keepdims=False, exclude=False, _fn=fn):
        ax = _norm_axis(axis, data.ndim, exclude)
        if ax is None:
            ax = tuple(range(data.ndim))
        if not ax:
            return data
        return _fn(data, dim=ax, keepdim=keepdims)


_reduce("sum", torch.sum, aliases=("sum_axis",))
_reduce("mean", torch.mean)
_reduce("max", torch.amax, aliases=("max_axis",))
_reduce("min", torch.amin, aliases=("min_axis",))
