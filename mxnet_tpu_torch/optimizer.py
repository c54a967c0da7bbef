"""Optimizers (mxnet_tpu/optimizer.py): the Optimizer base with per-index
update counts, lr/wd multipliers from parameter names and symbol
attributes, gradient rescale and clip, an lr_scheduler; SGD with
momentum; Adam; the `Updater` closure Module drives per parameter.

The update runs in place on the parameter's and the state's device
tensors, with the JAX package's arithmetic. SGD (sgd_mom_update):
    g   = clip(grad * rescale_grad)
    mom = momentum * mom - lr * (g + wd * weight)
    weight += mom
Adam runs the registered `adam_update` op with the bias-corrected lr
lr * sqrt(1 - beta2^t) / (1 - beta1^t) taken on the host, t the
parameter's update count. The other optimizers (NAG, RMSProp, ...) wait
for a later slice.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from . import ndarray as nd
from .base import MXNetError
from .ops.optimizer_ops import adam_update

_OPT_REGISTRY: dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lowercased name."""
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class Optimizer:
    """Base optimizer."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError(
                "param_idx2name should be a dict of param indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key not in _OPT_REGISTRY:
            raise MXNetError(f"Cannot find optimizer {name!r}")
        return _OPT_REGISTRY[key](**kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_mult(self, args_lr_mult):
        """Per-arg lr multipliers; symbol `__lr_mult__` attrs count."""
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """wd multiplier 0 for every name not ending in _weight/_gamma,
        unless overridden (symbol `__wd_mult__` attrs count)."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


create = Optimizer.create_optimizer


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = _prep_grad(grad._data, self.rescale_grad,
                           self.clip_gradient or -1.0)
            if state is None:
                w.sub_(lr * (g + wd * w))
                return
            mom = state._data
            mom.mul_(self.momentum).sub_(lr * (g + wd * w))
            w.add_(mom)

    def update_multi(self, indices, weights, grads, states):
        """`update` over many parameters at once: the same arithmetic
        as multi-tensor (torch._foreach) ops, one launch per op for each
        group of parameters sharing (lr, wd) instead of one per
        parameter."""
        groups = {}
        for index, w, g, s in zip(indices, weights, grads, states):
            self._update_count(index)
            key = (self._get_lr(index), self._get_wd(index))
            groups.setdefault(key, []).append(
                (w._data, g._data, None if s is None else s._data))
        clip = self.clip_gradient or -1.0
        with torch.no_grad():
            for (lr, wd), items in groups.items():
                ws = [w for w, _, _ in items]
                step = torch._foreach_mul([g for _, g, _ in items],
                                          self.rescale_grad)
                if clip > 0:
                    torch._foreach_clamp_min_(step, -clip)
                    torch._foreach_clamp_max_(step, clip)
                if wd:
                    torch._foreach_add_(step, torch._foreach_mul(ws, wd))
                torch._foreach_mul_(step, lr)
                if self.momentum == 0.0:
                    torch._foreach_sub_(ws, step)
                    continue
                moms = [m for _, _, m in items]
                torch._foreach_mul_(moms, self.momentum)
                torch._foreach_sub_(moms, step)
                torch._foreach_add_(ws, moms)


@register
class Adam(Optimizer):
    """Adam through the adam_update op, the bias-corrected lr applied on
    the host (mxnet_tpu/optimizer.py Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        with torch.no_grad():
            outs = adam_update(
                weight._data, grad._data, mean._data, var._data, lr=lr,
                beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                wd=wd, rescale_grad=self.rescale_grad,
                clip_gradient=self.clip_gradient or -1.0)
            for tgt, new in zip((weight, mean, var), outs):
                tgt._data.copy_(new)


class Updater:
    """Closure applying `optimizer` per (index, grad, weight), creating
    per-index state lazily; states (de)serialize for checkpoints."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def get_states(self):
        def _np(x):
            if isinstance(x, nd.NDArray):
                return x.asnumpy()
            if isinstance(x, (tuple, list)):
                return tuple(_np(i) for i in x)
            return x

        return pickle.dumps({k: _np(v) for k, v in self.states.items()})

    def set_states(self, states):
        def _nd(x, like):
            if isinstance(x, np.ndarray):
                return nd.array(x, ctx=like.context if like is not None
                                else None)
            return x

        loaded = pickle.loads(states)
        self.states = {k: _nd(v, self.states.get(k))
                       for k, v in loaded.items()}


def get_updater(optimizer):
    return Updater(optimizer)
