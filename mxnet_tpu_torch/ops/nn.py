"""Neural-network layer ops on the port's paths: Activation, LeakyReLU,
FullyConnected, Convolution, Pooling, BatchNorm, Dropout, SoftmaxOutput,
the regression heads (LinearRegressionOutput, MAERegressionOutput,
LogisticRegressionOutput) and MakeLoss, as in mxnet_tpu/ops/nn.py.

- Convolution and Pooling take MXNet's NCHW (channel-first) layout only;
  the channels-last rewrite of the pass pipeline is not ported.
- BatchNorm's moving statistics are functional, as in the JAX package:
  in training mode the op returns the updated moving mean and variance
  (from the biased batch variance) as trailing outputs, and the
  executor writes them back outside the autograd graph. With
  `fix_gamma` gamma is replaced by ones, so its gradient is zero.
- SoftmaxOutput, the regression heads and MakeLoss are loss heads whose
  gradient ignores the head gradient (MXNet's output-op contract):
  torch.autograd.Functions.
- Dropout draws its mask from the device's torch.Generator
  (mxnet_tpu_torch.random); the JAX package's bits are not reproduced.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, coerce_bool, coerce_float, coerce_int
from ..base import coerce_tuple
from .registry import register

# ------------------------------------------------------------ activation


@register("Activation", arg_names=["data"], defaults={"act_type": "relu"},
          aliases=("activation",))
def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    raise MXNetError(f"unknown act_type {act_type!r}")


def _leaky_arg_names(params):
    return ["data", "gamma"] if params.get("act_type") == "prelu" \
        else ["data"]


@register("LeakyReLU", arg_names_fn=_leaky_arg_names,
          defaults={"act_type": "leaky", "slope": 0.25,
                    "lower_bound": 0.125, "upper_bound": 0.334},
          coerce={"slope": coerce_float, "lower_bound": coerce_float,
                  "upper_bound": coerce_float},
          needs_rng=True, needs_mode=True)
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, rng=None,
               is_train=False):
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data >= 0, data, g * data)
    if act_type == "rrelu":
        if is_train:
            s = torch.rand(data.shape, generator=rng, device=data.device,
                           dtype=data.dtype)
            s = lower_bound + (upper_bound - lower_bound) * s
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, s * data)
    raise MXNetError(f"unknown act_type {act_type!r}")


# -------------------------------------------------------- fully connected
@register("FullyConnected", arg_names=["data", "weight", "bias"],
          coerce={"num_hidden": coerce_int, "no_bias": coerce_bool,
                  "flatten": coerce_bool},
          defaults={"no_bias": False, "flatten": True},
          aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    x = data.reshape((data.shape[0], -1)) if flatten else data
    return F.linear(x, weight, None if no_bias else bias)


# ------------------------------------------------------------ convolution
def _check_layout(layout, nd):
    if layout in (None, "", "None") or str(layout).upper() == \
            "NC" + "DHW"[3 - nd:]:
        return
    raise MXNetError(
        f"layout {layout!r}: only channel-first (NCHW) layouts are ported")


def _spatial_tuple(v, nd, default):
    t = coerce_tuple(v) if v not in (None, "", ()) else ()
    if not t:
        t = (default,) * nd
    if len(t) != nd:
        t = (t[0],) * nd
    return t


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", arg_names=["data", "weight", "bias"],
          coerce={"kernel": coerce_tuple, "stride": coerce_tuple,
                  "dilate": coerce_tuple, "pad": coerce_tuple,
                  "num_filter": coerce_int, "num_group": coerce_int,
                  "no_bias": coerce_bool, "workspace": coerce_int},
          defaults={"num_group": 1, "no_bias": False},
          aliases=("convolution",))
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                workspace=1024, cudnn_tune=None, cudnn_off=False,
                layout=None):
    """Convolution over NCHW data with OIHW weights."""
    nd = len(kernel)
    _check_layout(layout, nd)
    return _CONV[nd](data, weight, None if no_bias else bias,
                     stride=_spatial_tuple(stride, nd, 1),
                     padding=_spatial_tuple(pad, nd, 0),
                     dilation=_spatial_tuple(dilate, nd, 1),
                     groups=num_group)


# --------------------------------------------------------------- pooling
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling", arg_names=["data"],
          coerce={"kernel": coerce_tuple, "stride": coerce_tuple,
                  "pad": coerce_tuple, "global_pool": coerce_bool},
          defaults={"pool_type": "max", "global_pool": False,
                    "pooling_convention": "valid"},
          aliases=("pooling",))
def pooling(data, kernel=(), pool_type="max", global_pool=False,
            pooling_convention="valid", stride=(), pad=(), cudnn_off=False,
            layout=None):
    """Max / avg / sum pooling as the JAX package computes it: padding
    counts toward the average (the divisor is the full kernel size),
    and 'full' convention pads extra on the right so that
    ceil((in + 2p - k) / s) + 1 windows fit."""
    nd = data.ndim - 2
    _check_layout(layout, nd)
    dims = tuple(range(2, data.ndim))
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"unknown pool_type {pool_type!r}")
    if global_pool:
        if pool_type == "max":
            return torch.amax(data, dim=dims, keepdim=True)
        if pool_type == "sum":
            return torch.sum(data, dim=dims, keepdim=True)
        return torch.mean(data, dim=dims, keepdim=True)
    kernel = _spatial_tuple(kernel, nd, 1)
    stride = _spatial_tuple(stride, nd, 1)
    pad = _spatial_tuple(pad, nd, 0)
    right = list(pad)
    if pooling_convention == "full":
        for i in range(nd):
            in_ = data.shape[2 + i]
            out_ = int(math.ceil((in_ + 2 * pad[i] - kernel[i])
                                 / stride[i])) + 1
            needed = (out_ - 1) * stride[i] + kernel[i] - in_ - pad[i]
            right[i] = max(needed, pad[i])
    x, padding = data, pad
    if tuple(right) != tuple(pad) or any(
            p > k // 2 for p, k in zip(pad, kernel)):
        # explicit padding: -inf for max, zeros for avg/sum (counted)
        widths = []
        for i in reversed(range(nd)):
            widths += [pad[i], right[i]]
        fill = -math.inf if pool_type == "max" else 0.0
        x = F.pad(data, widths, value=fill)
        padding = (0,) * nd
    if pool_type == "max":
        return _MAXPOOL[nd](x, kernel, stride, padding)
    out = _AVGPOOL[nd](x, kernel, stride, padding, count_include_pad=True)
    if pool_type == "sum":
        out = out * float(math.prod(kernel))
    return out


# ------------------------------------------------------------- batchnorm
def _bn_num_outputs(params):
    return 3 if coerce_bool(params.get("output_mean_var", False)) else 1


@register("BatchNorm", arg_names=["data", "gamma", "beta"],
          aux_names=("moving_mean", "moving_var"),
          coerce={"eps": coerce_float, "momentum": coerce_float,
                  "fix_gamma": coerce_bool, "use_global_stats": coerce_bool,
                  "output_mean_var": coerce_bool, "axis": coerce_int},
          defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                    "use_global_stats": False, "output_mean_var": False,
                    "axis": 1},
          needs_mode=True, num_outputs_fn=_bn_num_outputs,
          aliases=("batch_norm",))
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               is_train=False):
    """Batch normalization over the channel axis (default 1). Training
    mode normalizes with the batch statistics and returns the updated
    moving mean/variance (biased batch variance) as trailing outputs."""
    axis = axis % data.ndim
    x = data if axis == 1 else data.movedim(axis, 1)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if is_train and not use_global_stats:
        out, mean, invstd = torch.native_batch_norm(
            x, g, beta, None, None, True, 0.0, eps)
        with torch.no_grad():
            var = torch.clamp_min(invstd.reciprocal().square() - eps, 0.0)
            new_mean = moving_mean * momentum + mean.to(
                moving_mean.dtype) * (1 - momentum)
            new_var = moving_var * momentum + var.to(
                moving_var.dtype) * (1 - momentum)
    else:
        mean, var = moving_mean, moving_var
        out = F.batch_norm(x, moving_mean, moving_var, g, beta,
                           training=False, eps=eps)
    if axis != 1:
        out = out.movedim(1, axis)
    outs = (out,)
    if output_mean_var:
        outs = (out, mean.detach().to(data.dtype), var.detach().to(
            data.dtype))
    if is_train:
        if use_global_stats:
            return outs + (moving_mean, moving_var)
        return outs + (new_mean, new_var)
    return outs if len(outs) > 1 else out


# --------------------------------------------------------------- dropout
@register("Dropout", arg_names=["data"], coerce={"p": coerce_float},
          defaults={"p": 0.5, "mode": "training"}, needs_rng=True,
          needs_mode=True, aliases=("dropout",))
def dropout(data, p=0.5, mode="training", rng=None, is_train=False):
    if not is_train and mode != "always":
        return data
    keep = 1.0 - p
    mask = torch.rand(data.shape, generator=rng, device=data.device) < keep
    return torch.where(mask, data / keep, torch.zeros_like(data))


# ---------------------------------------------------- output (loss) ops
_NORM_MAP = {0: "null", 1: "batch", 2: "valid",
             "null": "null", "batch": "batch", "valid": "valid"}


def _onehot(lab, nclass, dim, dtype):
    """One-hot along `dim`; out-of-range ids (an ignore label) give a
    zero row, as jax.nn.one_hot does."""
    shape = [1] * (lab.ndim + 1)
    shape[dim] = nclass
    ids = torch.arange(nclass, device=lab.device).reshape(shape)
    return (lab.unsqueeze(dim) == ids).to(dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; MXNet's loss gradient backward (prob - onehot,
    scaled and normalized), which ignores the head gradient unless
    out_grad."""

    @staticmethod
    def forward(ctx, data, label, params):
        multi_output, preserve_shape = params[2], params[4]
        if multi_output:
            prob = torch.softmax(data, dim=1)
        elif preserve_shape:
            prob = torch.softmax(data, dim=-1)
        else:
            prob = torch.softmax(data.reshape(data.shape[0], -1),
                                 dim=-1).reshape(data.shape)
        ctx.save_for_backward(prob, label)
        ctx.params = params
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        (grad_scale, ignore_label, multi_output, use_ignore, _,
         normalization, smooth_alpha, out_grad) = ctx.params
        if multi_output:
            lab = label.to(torch.int64)
            grad = prob - _onehot(lab, prob.shape[1], 1, prob.dtype)
            if use_ignore:
                valid = (label != ignore_label).to(prob.dtype)
                grad = grad * valid.unsqueeze(1)
        elif label.shape == prob.shape:
            grad = prob - label
        else:
            nclass = prob.shape[-1]
            lab = label.to(torch.int64).reshape(prob.shape[:-1])
            onehot = _onehot(lab, nclass, lab.ndim, prob.dtype)
            if smooth_alpha > 0:
                onehot = onehot * (1 - smooth_alpha) + smooth_alpha / (
                    nclass - 1) * (1 - onehot)
            grad = prob - onehot
            if use_ignore:
                valid = (lab != int(ignore_label)).to(prob.dtype)
                grad = grad * valid[..., None]
        if normalization == "batch":
            grad = grad / prob.shape[0]
        elif normalization == "valid":
            if use_ignore:
                if multi_output:
                    cnt = (label != ignore_label).to(prob.dtype).sum()
                else:
                    cnt = (label.to(torch.int64) != int(ignore_label)).to(
                        prob.dtype).sum()
                grad = grad / torch.clamp_min(cnt, 1.0)
            else:
                grad = grad / prob.shape[0]
        grad = grad * grad_scale
        if out_grad:
            grad = grad * g
        return grad, None, None


@register("SoftmaxOutput", arg_names=["data", "label"],
          coerce={"grad_scale": coerce_float, "ignore_label": coerce_float,
                  "multi_output": coerce_bool, "use_ignore": coerce_bool,
                  "preserve_shape": coerce_bool,
                  "normalization": lambda v: _NORM_MAP[v],
                  "smooth_alpha": coerce_float, "out_grad": coerce_bool},
          defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                    "multi_output": False, "use_ignore": False,
                    "preserve_shape": False, "normalization": "null",
                    "smooth_alpha": 0.0, "out_grad": False},
          no_grad_inputs=("label",), aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   smooth_alpha=0.0, out_grad=False):
    return _SoftmaxOutput.apply(
        data, label, (grad_scale, ignore_label, multi_output, use_ignore,
                      preserve_shape, normalization, smooth_alpha,
                      out_grad))


class _RegressionOutput(torch.autograd.Function):
    """fwd(data) forward; backward grad_scale / prod(label.shape[1:]) *
    bwd(out, label), whatever the head gradient; the label gets none."""

    @staticmethod
    def forward(ctx, data, label, fwd, bwd, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.bwd, ctx.grad_scale = bwd, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num_output = math.prod(label.shape[1:])
        grad = ctx.grad_scale / num_output * ctx.bwd(
            out, label.reshape(out.shape))
        return grad, None, None, None, None


def _regression_output(name, fwd, bwd):
    @register(name, arg_names=["data", "label"],
              coerce={"grad_scale": coerce_float},
              defaults={"grad_scale": 1.0}, no_grad_inputs=("label",))
    def _op(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, fwd, bwd, grad_scale)

    return _op


_regression_output("LinearRegressionOutput", lambda x: x,
                   lambda o, lab: o - lab)
_regression_output("MAERegressionOutput", lambda x: x,
                   lambda o, lab: torch.sign(o - lab))
_regression_output("LogisticRegressionOutput", torch.sigmoid,
                   lambda o, lab: o - lab)


class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward is grad_scale everywhere (divided by
    the batch under normalization='batch'), whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization):
        ctx.meta = (data.shape, data.dtype, data.device, grad_scale,
                    normalization)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device, grad_scale, normalization = ctx.meta
        grad = torch.full(shape, grad_scale, dtype=dtype, device=device)
        if normalization == "batch":
            grad = grad / shape[0]
        return grad, None, None


@register("MakeLoss", arg_names=["data"],
          coerce={"grad_scale": coerce_float,
                  "normalization": lambda v: _NORM_MAP.get(v, v)},
          defaults={"grad_scale": 1.0, "normalization": "null"},
          aliases=("make_loss",))
def make_loss(data, grad_scale=1.0, normalization="null", valid_thresh=0.0):
    return _MakeLoss.apply(data, grad_scale, normalization)
