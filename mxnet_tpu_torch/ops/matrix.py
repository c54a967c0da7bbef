"""Shape ops (flatten, Concat, SliceChannel, reshape), clip, and the
constant sources the folding pass produces (_zeros, _ones,
_graph_constant)."""
from __future__ import annotations

import ast

import torch

from ..base import MXNetError, coerce_bool, coerce_float, coerce_int
from ..base import coerce_tuple
from .registry import register
from .shape_infer import torch_dtype


def _infer_reshape(shape, src_shape, reverse=False):
    """MXNet reshape semantics: 0 copies input dim, -1 infers, -2 copies
    all remaining, -3 merges two dims, -4 splits a dim."""
    if reverse:
        src = list(reversed(src_shape))
        out = _infer_reshape(list(reversed(list(shape))), src, False)
        return tuple(reversed(out))
    src = list(src_shape)
    out = []
    src_idx = 0
    i = 0
    shape = list(shape)
    while i < len(shape):
        s = shape[i]
        if s > 0:
            out.append(s)
            src_idx += 1
        elif s == 0:
            out.append(src[src_idx])
            src_idx += 1
        elif s == -1:
            out.append(-1)
            src_idx += 1
        elif s == -2:
            out.extend(src[src_idx:])
            src_idx = len(src)
        elif s == -3:
            out.append(src[src_idx] * src[src_idx + 1])
            src_idx += 2
        elif s == -4:
            d1, d2 = shape[i + 1], shape[i + 2]
            cur = src[src_idx]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            src_idx += 1
            i += 2
        else:
            raise MXNetError(f"bad reshape token {s}")
        i += 1
    if out.count(-1) > 1:
        raise MXNetError("reshape can infer at most one dim")
    return tuple(out)


@register("reshape", arg_names=["data"],
          coerce={"shape": coerce_tuple, "reverse": coerce_bool},
          aliases=("Reshape",))
def reshape(data, shape=(), reverse=False, target_shape=None,
            keep_highest=False):
    if target_shape is not None and not shape:
        tgt = coerce_tuple(target_shape)
        if keep_highest:
            tgt = (data.shape[0],) + tuple(tgt)[1:]
        return torch.reshape(data, tgt)
    return torch.reshape(data, _infer_reshape(shape, data.shape, reverse))


@register("flatten", arg_names=["data"], aliases=("Flatten",))
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("clip", arg_names=["data"],
          coerce={"a_min": coerce_float, "a_max": coerce_float})
def clip(data, a_min=None, a_max=None):
    if a_min is None or a_max is None:
        raise MXNetError("clip requires both a_min and a_max")
    return torch.clamp(data, a_min, a_max)


@register("Concat", coerce={"dim": coerce_int, "num_args": coerce_int},
          defaults={"dim": 1}, aliases=("concat",))
def concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


@register("SliceChannel", arg_names=["data"],
          coerce={"num_outputs": coerce_int, "axis": coerce_int,
                  "squeeze_axis": coerce_bool},
          defaults={"axis": 1, "squeeze_axis": False},
          aliases=("slice_channel", "split"),
          num_outputs_fn=lambda p: int(p.get("num_outputs", 1)))
def slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False):
    """`num_outputs` equal parts along `axis` (views of `data`)."""
    size = data.shape[axis]
    if size % num_outputs:
        raise MXNetError(f"SliceChannel: axis {axis} of size {size} does "
                         f"not split into {num_outputs} equal parts")
    parts = torch.split(data, size // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


# ------------------------------------------------------ constant sources
# (host tensors: the executor moves a source op's result to its device)
@register("_zeros", coerce={"shape": coerce_tuple},
          defaults={"dtype": "float32"})
def _zeros(shape=(), dtype="float32", ctx=None):
    return torch.zeros(shape, dtype=torch_dtype(dtype))


@register("_ones", coerce={"shape": coerce_tuple},
          defaults={"dtype": "float32"})
def _ones(shape=(), dtype="float32", ctx=None):
    return torch.ones(shape, dtype=torch_dtype(dtype))


def _coerce_const_value(v):
    # serialized graphs carry the value as its repr (nested tuples)
    if isinstance(v, str):
        return ast.literal_eval(v)
    return v


@register("_graph_constant", coerce={"value": _coerce_const_value},
          defaults={"dtype": "float32"})
def _graph_constant(value=0.0, dtype="float32", ctx=None):
    """Result of constant folding (passes.fold), held as nested Python
    lists so it survives the JSON round trip."""
    return torch.tensor(value, dtype=torch_dtype(dtype))
