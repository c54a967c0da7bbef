"""Python-defined operators: the counterpart of mxnet_tpu/operator.py.

Three generations, as in the JAX package and the reference MXNet:

- `CustomOp` / `CustomOpProp` + `register`: the supported API. Ops run
  through the `Custom` op (ops/custom.py, a torch.autograd.Function)
  and appear as `mx.sym.Custom(..., op_type=name)`. Their bodies get
  NDArrays on the graph's device, so device code (`rtc.CudaKernel`)
  runs without a host round trip.
- `NDArrayOp` and `NumpyOp`: the legacy single-class styles, adapters
  that register an equivalent CustomOpProp and whose `get_symbol()`
  emits the Custom node. NumpyOp bodies get numpy arrays (a host round
  trip each way); NDArrayOp bodies get NDArrays.
"""
from __future__ import annotations

import itertools

import numpy as np

from .base import MXNetError
from .ops import custom as _custom


class CustomOp:
    """Base class for operators implemented in Python."""

    def __init__(self):
        pass

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Assign src to dst according to req: 'null' leaves dst,
        'write' and 'inplace' overwrite it, 'add' accumulates."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """Properties of a CustomOp: its inputs, outputs, shapes, types and
    backward dependencies."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a CustomOpProp subclass under op_type `reg_name`."""

    def do_register(prop_cls):
        _custom.register_prop(reg_name, prop_cls)
        return prop_cls

    return do_register


def get_all_registered():
    return dict(_custom._PROP_REGISTRY)


# --------------------------------------------------------------- legacy APIs
_legacy_counter = itertools.count()


class _LegacyAdapterProp(CustomOpProp):
    """CustomOpProp facade over a PythonOp instance."""

    def __init__(self, pyop=None, **_kwargs):
        super().__init__(need_top_grad=pyop.need_top_grad())
        self._op = pyop

    def list_arguments(self):
        return self._op.list_arguments()

    def list_outputs(self):
        return self._op.list_outputs()

    def infer_shape(self, in_shape):
        ins, outs = self._op.infer_shape(in_shape)
        return ins, outs, []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return _LegacyAdapterOp(self._op)


class _LegacyAdapterOp(CustomOp):
    def __init__(self, pyop):
        super().__init__()
        self._op = pyop

    def forward(self, is_train, req, in_data, out_data, aux):
        self._op.forward(in_data=in_data, out_data=out_data)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self._op.backward(out_grad=out_grad, in_data=in_data,
                          out_data=out_data, in_grad=in_grad)


class PythonOp:
    """Base for the legacy NumpyOp/NDArrayOp styles."""

    _adapter = _LegacyAdapterProp

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad
        self._reg_name = None

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    def get_symbol(self, *args, **kwargs):
        """The Custom symbol of this op applied to `args`."""
        from . import symbol

        if self._reg_name is None:
            self._reg_name = (
                f"_legacy_{type(self).__name__}_{next(_legacy_counter)}")
            op, adapter = self, self._adapter
            _custom.register_prop(self._reg_name,
                                  lambda **kw: adapter(pyop=op))
        kwargs["op_type"] = self._reg_name
        return symbol.Custom(*args, **kwargs)

    __call__ = get_symbol


class _NumpyAdapterOp(CustomOp):
    def __init__(self, pyop):
        super().__init__()
        self._op = pyop

    def forward(self, is_train, req, in_data, out_data, aux):
        np_in = [x.asnumpy() for x in in_data]
        np_out = [np.zeros(x.shape, x.dtype) for x in out_data]
        self._op.forward(in_data=np_in, out_data=np_out)
        for dst, src in zip(out_data, np_out):
            dst[:] = src

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        np_og = [x.asnumpy() for x in out_grad]
        np_in = [x.asnumpy() for x in in_data]
        np_out = [x.asnumpy() for x in out_data]
        np_ig = [np.zeros(x.shape, x.dtype) for x in in_grad]
        self._op.backward(out_grad=np_og, in_data=np_in, out_data=np_out,
                          in_grad=np_ig)
        for dst, src in zip(in_grad, np_ig):
            dst[:] = src


class _NumpyAdapterProp(_LegacyAdapterProp):
    def create_operator(self, ctx, in_shapes, in_dtypes):
        return _NumpyAdapterOp(self._op)


class NumpyOp(PythonOp):
    """Legacy custom op whose forward and backward receive numpy
    arrays."""

    _adapter = _NumpyAdapterProp


class NDArrayOp(PythonOp):
    """Legacy custom op whose forward and backward receive NDArrays on
    the graph's device."""
