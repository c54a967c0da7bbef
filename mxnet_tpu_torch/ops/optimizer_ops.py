"""Optimizer-update ops (mxnet_tpu/ops/optimizer_ops.py): `adam_update`.

XLA fused the JAX package's update into one computation; here it is
stock torch elementwise ops with the same arithmetic, functional as the
registered op (it returns the new weight, mean and var), and written
back in place by `optimizer.Adam`.
"""
from __future__ import annotations

import torch

from ..base import coerce_float
from .registry import register

_F = {name: coerce_float for name in (
    "lr", "wd", "rescale_grad", "clip_gradient", "beta1", "beta2",
    "epsilon")}


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register("adam_update", arg_names=["weight", "grad", "mean", "var"],
          num_outputs=3, coerce=_F,
          defaults={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                    "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0})
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (weight', mean', var')."""
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_weight = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_weight, new_mean, new_var
