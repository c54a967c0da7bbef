"""The `Custom` op: Python-defined operators inside symbolic graphs.

The counterpart of mxnet_tpu/ops/custom.py. A CustomOpProp subclass
registered under an op_type string (`operator.register`) supplies
list_arguments / list_outputs / infer_shape / infer_type and a CustomOp
whose forward and backward are Python. The JAX package runs them as
host callbacks (`jax.pure_callback`) under `jax.custom_vjp`; here the
op is a `torch.autograd.Function`:

  forward   calls the user's `forward(is_train, req, in_data, out_data,
            aux)` with no autograd recording, on NDArrays that wrap the
            device tensors (no host round trip: an op that calls
            `asnumpy()` pays for it itself, as in the reference) and
            zeroed outputs with req "write";
  backward  calls the same op's `backward(req, out_grad, in_data,
            out_data, in_grad, aux)` with zeroed in_grads of req "write".
            out_grad is the head gradient autograd hands down: the
            Executor seeds a head with ones, so a loss head with
            need_top_grad=False receives ones and ignores them, as in
            the JAX package.

Shape inference asks the prop (`_custom_rule` fills unknown inputs such
as a label; the outputs come from `infer_shape` on "meta" tensors
without calling the user's code). Ops with auxiliary states are refused,
as in the JAX package.
"""
from __future__ import annotations

import functools

import torch

from .. import context as _context
from .. import ndarray as _nd  # NDArray read at call time: ndarray imports ops
from ..base import MXNetError
from . import shape_infer as _shape_infer
from .registry import register
from .shape_infer import numpy_dtype, torch_dtype

_PROP_REGISTRY: dict[str, type] = {}


def register_prop(reg_name, prop_cls):
    if _PROP_REGISTRY.get(reg_name) is not prop_cls:
        # re-registration must not serve stale prop instances out of the
        # cache
        _make_prop.cache_clear()
    _PROP_REGISTRY[reg_name] = prop_cls


def get_prop_cls(reg_name):
    try:
        return _PROP_REGISTRY[reg_name]
    except KeyError:
        raise MXNetError(
            f"unknown custom op type {reg_name!r}; register a "
            "CustomOpProp with mx.operator.register first") from None


@functools.lru_cache(maxsize=None)
def _make_prop(op_type, kwargs_items):
    cls = get_prop_cls(op_type)
    prop = cls(**dict(kwargs_items))
    prop._op_type = op_type
    prop._kwargs = dict(kwargs_items)
    return prop


def _prop_from_params(params):
    kwargs = {k: v for k, v in params.items() if k != "op_type"}
    return _make_prop(params["op_type"], tuple(sorted(kwargs.items())))


def _custom_arg_names(params):
    return list(_prop_from_params(params).list_arguments())


def _custom_num_outputs(params):
    return len(_prop_from_params(params).list_outputs())


def _infer_shapes(prop, in_shapes):
    """Normalize prop.infer_shape's 2- or 3-tuple return."""
    ret = prop.infer_shape(list(in_shapes))
    if len(ret) == 2:
        ins, outs = ret
        auxs = []
    else:
        ins, outs, auxs = ret
    return ([tuple(s) for s in ins], [tuple(s) for s in outs],
            [tuple(s) for s in auxs])


class _Spec:
    """What one Custom call needs beside its tensors."""

    __slots__ = ("prop", "is_train", "out_shapes", "out_dtypes")

    def __init__(self, prop, is_train, out_shapes, out_dtypes):
        self.prop = prop
        self.is_train = is_train
        self.out_shapes = out_shapes
        self.out_dtypes = out_dtypes


class _CustomFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spec, *ins):
        dev = ins[0].device
        op = spec.prop.create_operator(
            _context.as_context(dev), [tuple(x.shape) for x in ins],
            [numpy_dtype(x.dtype) for x in ins])
        out_data = [_nd.NDArray(torch.zeros(s, dtype=d, device=dev))
                    for s, d in zip(spec.out_shapes, spec.out_dtypes)]
        op.forward(is_train=spec.is_train, req=["write"] * len(out_data),
                   in_data=[_nd.NDArray(x) for x in ins], out_data=out_data,
                   aux=[])
        outs = tuple(o._data for o in out_data)
        ctx.op = op
        ctx.n_in = len(ins)
        ctx.save_for_backward(*ins, *outs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_grad = [_nd.NDArray(torch.zeros_like(x)) for x in ins]
        ctx.op.backward(req=["write"] * len(in_grad),
                        out_grad=[_nd.NDArray(g) for g in grads],
                        in_data=[_nd.NDArray(x) for x in ins],
                        out_data=[_nd.NDArray(o) for o in outs],
                        in_grad=in_grad, aux=[])
        return (None,) + tuple(
            g._data if need else None
            for g, need in zip(in_grad, ctx.needs_input_grad[1:]))


def custom_fn(*inputs, is_train=False, **params):
    """Body of the Custom op; on "meta" inputs (shape inference) the
    outputs come from the prop alone."""
    prop = _prop_from_params(params)
    if prop.list_auxiliary_states():
        raise MXNetError(
            "Custom ops with auxiliary states are not supported yet")
    n_out = len(prop.list_outputs())
    _, out_shapes, _ = _infer_shapes(prop, [tuple(x.shape) for x in inputs])
    types = prop.infer_type([numpy_dtype(x.dtype) for x in inputs])
    out_dtypes = [torch_dtype(d) for d in types[1]]
    if any(x.device.type == "meta" for x in inputs):
        out = tuple(torch.empty(s, dtype=d, device="meta")
                    for s, d in zip(out_shapes, out_dtypes))
    else:
        out = _CustomFunction.apply(
            _Spec(prop, bool(is_train), out_shapes, out_dtypes), *inputs)
    return out if n_out > 1 else out[0]


register("Custom", arg_names=None, arg_names_fn=_custom_arg_names,
         num_outputs_fn=_custom_num_outputs, needs_mode=True)(custom_fn)


@_shape_infer.rule("Custom")
def _custom_rule(params, ins):
    """The prop fills unknown input shapes (the reference calls
    CustomOpProp.infer_shape from the InferShape pass)."""
    new_ins, _, _ = _infer_shapes(_prop_from_params(params), list(ins))
    return list(new_ins), None
