"""Forward shape/type inference for symbolic binding.

Only ops that create parameter or label shapes (FullyConnected infers
its weight from the data shape, with flatten=False from the last axis of
3-D data; a loss head infers its label) have hand-written rules; every
other output shape and dtype (SliceChannel's parts, RingAttention's
output) comes from running the op's own function on "meta" tensors,
which carry shape and dtype but no data.

An infer rule has signature
    fn(params, in_shapes) -> (in_shapes, out_shapes)
where `in_shapes` is a list of tuples-or-None (None = unknown, to be
inferred); the returned in_shapes must be fully known. Inputs include
trailing aux states for ops that have them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

_RULES: dict[str, callable] = {}

_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(dt):
    """torch dtype of a numpy dtype, dtype name or torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    if dt is None:
        return torch.float32
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    name = {"float": "float32", "bf16": "bfloat16"}.get(name, name)
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dt!r}") from None


def numpy_dtype(dt):
    """numpy dtype of a torch dtype (bfloat16 has none: its name is
    kept as a string by callers that need it)."""
    if isinstance(dt, torch.dtype):
        name = str(dt).replace("torch.", "")
        if name == "bfloat16":
            return "bfloat16"
        return np.dtype(name)
    return np.dtype(dt)


def rule(name):
    def deco(fn):
        _RULES[name] = fn
        return fn

    return deco


def _prod(t):
    p = 1
    for x in t:
        p *= x
    return p


def infer_node(opdef, params, in_shapes, in_dtypes):
    """Infer (in_shapes, out_shapes, out_dtypes) for one node; raises
    MXNetError when the known inputs do not determine them."""
    r = _RULES.get(opdef.name)
    if r is not None:
        in_shapes, _ = r(params, list(in_shapes))
    if any(s is None for s in in_shapes):
        missing = [i for i, s in enumerate(in_shapes) if s is None]
        raise MXNetError(
            f"op {opdef.name!r}: cannot infer shapes of inputs {missing}")
    metas = [torch.empty(tuple(s), dtype=torch_dtype(d), device="meta")
             for s, d in zip(in_shapes, in_dtypes)]
    extra = {}
    if opdef.needs_rng:
        extra["rng"] = None
    if opdef.needs_mode:
        extra["is_train"] = False
    with torch.no_grad():
        out = opdef.fn(*metas, **params, **extra)
    if not isinstance(out, (tuple, list)):
        out = (out,)
    n_out = opdef.resolved_num_outputs(params)
    out = tuple(out)[:n_out]
    return ([tuple(s) for s in in_shapes],
            [tuple(o.shape) for o in out],
            [numpy_dtype(o.dtype) for o in out])


# --------------------------------------------------- parameter-creating ops
@rule("FullyConnected")
def _fc(params, ins):
    data, weight, bias = (ins + [None] * 3)[:3]
    nh = int(params["num_hidden"])
    no_bias = params.get("no_bias", False)
    if data is not None:
        d = _prod(data[1:]) if params.get("flatten", True) else data[-1]
        if weight is None:
            weight = (nh, d)
    if weight is None:
        raise MXNetError("FullyConnected: cannot infer weight shape")
    if no_bias:
        return [data, weight], None
    if bias is None:
        bias = (nh,)
    return [data, weight, bias], None


@rule("Convolution")
def _conv(params, ins):
    data, weight, bias = (ins + [None] * 3)[:3]
    nf = int(params["num_filter"])
    ng = int(params.get("num_group", 1))
    kernel = tuple(params["kernel"])
    no_bias = params.get("no_bias", False)
    if data is not None and weight is None:
        weight = (nf, data[1] // ng) + kernel
    if no_bias:
        return [data, weight], None
    if bias is None:
        bias = (nf,)
    return [data, weight, bias], None


@rule("BatchNorm")
def _bn(params, ins):
    data = ins[0]
    if data is None:
        raise MXNetError("BatchNorm: data shape required")
    c = (data[int(params.get("axis", 1)) % len(data)],)
    out = [data] + [s if s is not None else c for s in ins[1:]]
    while len(out) < 5:
        out.append(c)
    return out, None


def _label_rule(label_like_data=False):
    def fn(params, ins):
        data, label = (ins + [None] * 2)[:2]
        if data is not None and label is None:
            if label_like_data:
                # regression: label shaped like data, except (N,1)->(N,)
                label = ((data[0],) if len(data) == 2 and data[1] == 1
                         else data)
            elif params.get("multi_output"):
                label = (data[0],) + tuple(data[2:])
            elif params.get("preserve_shape"):
                label = tuple(data[:-1])
            else:
                label = (data[0],)
        return [data, label], None

    return fn


_RULES["SoftmaxOutput"] = _label_rule(False)
for _n in ("LinearRegressionOutput", "MAERegressionOutput",
           "LogisticRegressionOutput"):
    _RULES[_n] = _label_rule(True)
