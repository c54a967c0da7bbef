"""Elementwise unary/binary/scalar ops: every op of the fusion pass's
ELEMWISE_OPS set (passes/transforms.py), as plain torch functions.

These are also the plain versions of the generated fusion kernels
(passes/codegen.py composes them into a group's chain), so each one
computes what its mxnet_tpu/ops/elemwise.py counterpart computes:
`_mod` takes the sign of the divisor (numpy's mod).
"""
from __future__ import annotations

import torch

from ..base import coerce_float
from .registry import register
from .shape_infer import torch_dtype


def _unary(name, fn, aliases=()):
    register(name, arg_names=["data"], aliases=aliases)(
        lambda data, _fn=fn: _fn(data))


_unary("relu", torch.relu, aliases=("Relu",))
_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("square", torch.square)
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("negative", torch.neg)
_unary("reciprocal", torch.reciprocal)
_unary("softsign", lambda x: x / (1 + torch.abs(x)))
_unary("erf", torch.erf)
_unary("_copy", lambda x: x)
_unary("identity", lambda x: x)


@register("cast", arg_names=["data"], aliases=("Cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


# --------------------------------------------------------------- binary
def _binary(name, fn, aliases=()):
    register(name, arg_names=["lhs", "rhs"], aliases=aliases)(
        lambda lhs, rhs, _fn=fn: _fn(lhs, rhs))


def _mod(a, b):
    return torch.remainder(a, b)


_binary("elemwise_add", torch.add, aliases=("_plus", "_Plus"))
_binary("elemwise_sub", torch.sub, aliases=("_minus", "_Minus"))
_binary("elemwise_mul", torch.mul, aliases=("_mul", "_Mul"))
_binary("elemwise_div", torch.div, aliases=("_div", "_Div"))
_binary("_power", torch.pow, aliases=("_Power", "pow"))
_binary("_maximum", torch.maximum, aliases=("_Maximum",))
_binary("_minimum", torch.minimum, aliases=("_Minimum",))
_binary("_mod", _mod, aliases=("_Mod",))

for _name, _fn in [
    ("broadcast_add", torch.add),
    ("broadcast_sub", torch.sub),
    ("broadcast_mul", torch.mul),
    ("broadcast_div", torch.div),
    ("broadcast_power", torch.pow),
    ("broadcast_maximum", torch.maximum),
    ("broadcast_minimum", torch.minimum),
]:
    _binary(_name, _fn)

# --------------------------------------------------------------- scalar
_SCALAR_COERCE = {"scalar": coerce_float}


def _scalar_op(name, fn, aliases=()):
    register(name, arg_names=["data"], coerce=_SCALAR_COERCE,
             aliases=aliases)(
        lambda data, scalar=0.0, _fn=fn: _fn(data, scalar))


def _rpow(x, s):
    return torch.pow(torch.as_tensor(s, dtype=x.dtype, device=x.device), x)


_scalar_op("_plus_scalar", lambda x, s: x + s, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", lambda x, s: x - s, aliases=("_MinusScalar",))
_scalar_op("_rminus_scalar", lambda x, s: s - x,
           aliases=("_RMinusScalar",))
_scalar_op("_mul_scalar", lambda x, s: x * s, aliases=("_MulScalar",))
_scalar_op("_div_scalar", lambda x, s: x / s, aliases=("_DivScalar",))
_scalar_op("_rdiv_scalar", lambda x, s: s / x, aliases=("_RDivScalar",))
_scalar_op("_power_scalar", lambda x, s: torch.pow(x, s),
           aliases=("_PowerScalar",))
_scalar_op("_rpower_scalar", _rpow, aliases=("_RPowerScalar",))
_scalar_op("_maximum_scalar", lambda x, s: torch.clamp_min(x, s),
           aliases=("_MaximumScalar",))
_scalar_op("_minimum_scalar", lambda x, s: torch.clamp_max(x, s),
           aliases=("_MinimumScalar",))


@register("smooth_l1", arg_names=["data"], coerce=_SCALAR_COERCE,
          defaults={"scalar": 1.0})
def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    absx = torch.abs(data)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * torch.square(data),
                       absx - 0.5 / s2)
