"""Forward shape/type inference for symbolic binding.

Only ops that create parameter or label shapes (FullyConnected infers
its weight from the data shape, with flatten=False from the last axis of
3-D data; Convolution and Deconvolution their weights; InstanceNorm its
gamma and beta; Embedding its table; LeakyReLU's prelu its per-channel
gamma; RNN its packed parameter blob and begin states; a loss head
infers its label) have hand-written rules, the JAX package's; every
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


# (op, params, input shapes and dtypes) -> a node's inferred outputs: a
# graph's repeated blocks (Inception-ResNet-v2's 40 residual blocks) and
# a bind at a new batch size meet the same nodes again, and running an
# op on meta tensors costs far more than the lookup
_NODE_MEMO = {}
_NODE_MEMO_CAP = 8192


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
    key = None
    if opdef.name != "Custom":   # a CustomOpProp may read other state
        key = (opdef.name, repr(sorted(params.items())),
               tuple(tuple(s) for s in in_shapes),
               tuple(str(d) for d in in_dtypes))
        hit = _NODE_MEMO.get(key)
        if hit is not None:
            return [tuple(s) for s in in_shapes], list(hit[0]), list(hit[1])
    outs = _infer_node_meta(opdef, params, in_shapes, in_dtypes)
    if key is not None:
        if len(_NODE_MEMO) >= _NODE_MEMO_CAP:
            _NODE_MEMO.clear()
        _NODE_MEMO[key] = (tuple(outs[1]), tuple(outs[2]))
    return outs


def _infer_node_meta(opdef, params, in_shapes, in_dtypes):
    """infer_node's work: the op run on meta tensors."""
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


@rule("MoEFFN")
def _moe_ffn(params, ins):
    data, gate_w, w1, w2 = (ins + [None] * 4)[:4]
    e = int(params["num_experts"])
    f = int(params["hidden_size"])
    if data is not None:
        d = data[-1]
        if gate_w is None:
            gate_w = (d, e)
        if w1 is None:
            w1 = (e, d, f)
        if w2 is None:
            w2 = (e, f, d)
    return [data, gate_w, w1, w2], None


@rule("Convolution")
def _conv(params, ins):
    data, weight, bias = (ins + [None] * 3)[:3]
    nf = int(params["num_filter"])
    ng = int(params.get("num_group", 1))
    kernel = tuple(params["kernel"])
    no_bias = params.get("no_bias", False)
    channels_last = str(params.get("layout") or "").upper().endswith("C")
    if data is not None and weight is None:
        if channels_last:  # e.g. NHWC -> OHWI weights
            weight = (nf,) + kernel + (data[-1] // ng,)
        else:
            weight = (nf, data[1] // ng) + kernel
    if no_bias:
        return [data, weight], None
    if bias is None:
        bias = (nf,)
    return [data, weight, bias], None


@rule("Deconvolution")
def _deconv(params, ins):
    """(C_in, num_filter / num_group, k...) weights: the JAX package's
    rule, although its op ignores num_group."""
    data, weight, bias = (ins + [None] * 3)[:3]
    nf = int(params["num_filter"])
    ng = int(params.get("num_group", 1))
    kernel = tuple(params["kernel"])
    if data is not None and weight is None:
        weight = (data[1], nf // ng) + kernel
    if params.get("no_bias", True):
        return [data, weight], None
    return [data, weight, bias or (nf,)], None


@rule("InstanceNorm")
def _in(params, ins):
    c = (ins[0][1],)
    return [ins[0], ins[1] or c, ins[2] if len(ins) > 2 and ins[2]
            else c], None


@rule("Embedding")
def _emb(params, ins):
    data, weight = (ins + [None] * 2)[:2]
    if weight is None:
        weight = (int(params["input_dim"]), int(params["output_dim"]))
    return [data, weight], None


@rule("RNN")
def _rnn(params, ins):
    """The packed blob's length and (layers · directions, N, H) begin
    states from the (T, N, input) data."""
    from .rnn_op import rnn_param_size

    mode = params["mode"]
    h = int(params["state_size"])
    num_layers = int(params.get("num_layers", 1))
    bidir = bool(params.get("bidirectional", False))
    if ins[0] is None:
        raise MXNetError("RNN: data shape required")
    _, n, input_size = ins[0]
    states = (num_layers * (2 if bidir else 1), n, h)
    out = [ins[0], ins[1] or (rnn_param_size(input_size, h, num_layers,
                                             bidir, mode),),
           ins[2] or states]
    if mode == "lstm":
        out.append(ins[3] if len(ins) > 3 and ins[3] else states)
    return out, None


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


@rule("LeakyReLU")
def _lrelu(params, ins):
    """prelu's gamma is one slope per channel (axis 1 of the data)."""
    if params.get("act_type") == "prelu" and ins and ins[0] is not None:
        gamma = ins[1] if len(ins) > 1 and ins[1] else (ins[0][1],)
        return [ins[0], gamma], None
    return ins, None


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


for _n in ("SoftmaxOutput", "SVMOutput", "softmax_cross_entropy"):
    _RULES[_n] = _label_rule(False)
for _n in ("LinearRegressionOutput", "MAERegressionOutput",
           "LogisticRegressionOutput"):
    _RULES[_n] = _label_rule(True)
