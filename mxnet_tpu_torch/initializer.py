"""Weight initializers (mxnet_tpu/initializer.py).

An `Initializer` is callable on (InitDesc | name, NDArray) and dispatches
on the name's suffix (weight, bias, gamma, beta, moving_mean,
moving_var), with a Variable's `__init__` attribute taking precedence.
Draws come from `random.np_rng()` (numpy's global RandomState) in the
same order and with the same calls as the JAX package, so under one
`mx.random.seed` the initial weights are bit-identical. The values are
filled on the host and copied to the array's device once.

Ported: Zero, One, Constant, Uniform, Normal, Xavier. MSRAPrelu, Load,
Mixed, Orthogonal, Bilinear, LSTMBias and FusedRNN wait.
"""
from __future__ import annotations

import json
import math

import numpy as np

from .base import MXNetError
from .random import np_rng

_INIT_REGISTRY: dict[str, type] = {}


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    for alias in getattr(klass, "aliases", ()):
        _INIT_REGISTRY[alias.lower()] = klass
    return klass


class InitDesc(str):
    """Name + attrs descriptor handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base: dispatch by name suffix; subclasses override _init_weight."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            create(klass, **kwargs)._init_weight(desc, arr)
        else:
            self._init_impl(desc, arr)

    def _init_impl(self, name, arr):
        if name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var") or name.endswith("running_var"):
            self._init_one(name, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    # ------------------------------------------------------------ fills
    def _set(self, arr, value):
        arr[:] = np.asarray(value, dtype=arr.dtype)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Initializer must override _init_weight")

    def _init_default(self, name, arr):
        raise MXNetError(
            f"Unknown initialization pattern for {name}. Default "
            "initialization is now limited to *weight/*bias/*gamma/*beta. "
            "Use mx.sym.Variable(init=...) to set initialization pattern.")


@register
class Zero(Initializer):
    aliases = ("zeros",)

    def _init_weight(self, _, arr):
        arr[:] = 0.0

    _init_default = _init_weight


@register
class One(Initializer):
    aliases = ("ones",)

    def _init_weight(self, _, arr):
        arr[:] = 1.0

    _init_default = _init_weight


@register
class Constant(Initializer):
    """Fill with a constant value, whatever the parameter's name."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value

    _init_impl = _init_weight


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._set(arr, np_rng().uniform(-self.scale, self.scale, arr.shape))


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._set(arr, np_rng().normal(0.0, self.sigma, arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot: rnd_type ('uniform' | 'gaussian'), factor_type
    ('avg' | 'in' | 'out'), magnitude."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(
                f"Xavier initializer cannot init {name} with shape {shape};"
                " use init=mx.init.Constant or similar for 1D arrays")
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, np_rng().uniform(-scale, scale, shape))
        elif self.rnd_type == "gaussian":
            self._set(arr, np_rng().normal(0, scale, shape))
        else:
            raise MXNetError("Unknown random type")


def create(name, **kwargs):
    """Create an initializer by registered name (or pass one through)."""
    if isinstance(name, Initializer):
        return name
    key = name.lower()
    if key not in _INIT_REGISTRY:
        raise MXNetError(f"unknown initializer {name!r}")
    return _INIT_REGISTRY[key](**kwargs)
