"""Neural-network layer ops on the port's paths: Activation, LeakyReLU,
FullyConnected, Convolution, Pooling, BatchNorm, softmax, log_softmax,
Dropout, SoftmaxOutput,
the regression heads (LinearRegressionOutput, MAERegressionOutput,
LogisticRegressionOutput) and MakeLoss, as in mxnet_tpu/ops/nn.py.

- Convolution and Pooling take any layout the JAX package takes (NCHW
  by default, or channels-last NHWC/NWC/NDHWC, any order that names N
  and C), with the weight in the data's orientation (N -> O, C -> I:
  NHWC weights are OHWI). The data and weight are permuted to
  channel-first views for torch and the output back; the channels-last
  rewrite of the pass pipeline is not ported. Deconvolution accepts
  `layout` and ignores it, as the JAX op does.
- BatchNorm's moving statistics are functional, as in the JAX package:
  in training mode the op returns the updated moving mean and variance
  (from the biased batch variance) as trailing outputs, and the
  executor writes them back outside the autograd graph. With
  `fix_gamma` gamma is replaced by ones, so its gradient is zero.
  Inside `global_batch_statistics(all_reduce, all_gather)` (the fused
  step across worker processes) the statistics are the global batch's:
  forward combines every process's count, mean and squared deviations,
  and backward sums the two per-channel terms of the input gradient;
  gamma's and beta's gradients stay this process's share, summed later
  with every other gradient.
- SoftmaxOutput, the regression heads and MakeLoss are loss heads whose
  gradient ignores the head gradient (MXNet's output-op contract):
  torch.autograd.Functions.
- Dropout draws its mask from the device's torch.Generator
  (mxnet_tpu_torch.random); the JAX package's bits are not reproduced.
"""
from __future__ import annotations

import contextlib
import math
import threading

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


@register("LeakyReLU", arg_names=["data", "gamma"],
          arg_names_fn=_leaky_arg_names,
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
    if x.dtype != weight.dtype:
        # jnp.matmul's promotion (a bfloat16 activation against a
        # float32 weight computes in float32)
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    if no_bias or bias is None:
        return F.linear(x, weight)
    if bias.dtype != x.dtype:
        return F.linear(x, weight) + bias
    return F.linear(x, weight, bias)


# ------------------------------------------------------------ convolution
def _norm_layout(layout, nd):
    """The layout string ('NCHW', 'NHWC', 'NCDHW', 'NDHWC', 'NCW',
    'NWC', ...), channel-first by default, as the JAX package resolves
    it."""
    if not layout or layout in ("None",):
        return "NC" + "DHW"[3 - nd:]
    layout = str(layout).upper()
    if len(layout) != nd + 2 or "N" not in layout or "C" not in layout:
        raise MXNetError(f"bad conv layout {layout!r} for {nd}d")
    return layout


def _to_channel_first(layout):
    """The permutation taking `layout` to (N, C, spatial...), the
    spatial axes in the layout's order (the order of kernel, stride and
    pad), and its inverse; None for a channel-first layout."""
    perm = [layout.index("N"), layout.index("C")] + [
        i for i, ch in enumerate(layout) if ch not in "NC"]
    if perm == list(range(len(layout))):
        return None
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return perm, inv


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
    """Convolution in any layout of `_norm_layout`; the weight in the
    data's orientation (NCHW data with OIHW weights, NHWC with OHWI)."""
    nd = len(kernel)
    perms = _to_channel_first(_norm_layout(layout, nd))
    if perms is not None:
        data, weight = data.permute(perms[0]), weight.permute(perms[0])
    out = _CONV[nd](data, weight, None if no_bias else bias,
                    stride=_spatial_tuple(stride, nd, 1),
                    padding=_spatial_tuple(pad, nd, 0),
                    dilation=_spatial_tuple(dilate, nd, 1),
                    groups=num_group)
    return out if perms is None else out.permute(perms[1])


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
    ceil((in + 2p - k) / s) + 1 windows fit. Any layout of
    `_norm_layout`: a channels-last one pools a channel-first view."""
    nd = data.ndim - 2
    perms = _to_channel_first(_norm_layout(layout, nd))
    if perms is not None:
        out = pooling(data.permute(perms[0]), kernel, pool_type, global_pool,
                      pooling_convention, stride, pad)
        return out.permute(perms[1])
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
_global_stats = threading.local()


@contextlib.contextmanager
def global_batch_statistics(all_reduce, all_gather):
    """Training-mode BatchNorm inside the block normalizes with the
    statistics of the global batch, whose other rows other processes
    hold: `all_reduce(t)` sums a float32 tensor in place over them and
    `all_gather(t)` stacks every process's `t` in rank order."""
    prev = getattr(_global_stats, "ops", None)
    _global_stats.ops = (all_reduce, all_gather)
    try:
        yield
    finally:
        _global_stats.ops = prev


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch normalization over channel axis 1 with the global batch's
    statistics; returns (out, mean, biased variance). Forward gathers
    each process's row count, mean and sum of squared deviations (one
    collective) and combines them in rank order (Chan et al.'s pairwise
    update), so every process gets the same statistics; backward sums
    the two per-channel terms of the input gradient (one collective)."""

    @staticmethod
    def forward(ctx, x, g, beta, eps, ops):
        all_reduce, all_gather = ops
        dims = [0] + list(range(2, x.ndim))
        view = [1, -1] + [1] * (x.ndim - 2)
        c = x.shape[1]
        xf = x.float()
        local_mean = xf.mean(dims)
        dev = xf - local_mean.view(view)
        local = torch.cat([local_mean.new_tensor([float(x.numel() // c)]),
                           local_mean, (dev * dev).sum(dims)])
        every = all_gather(local)
        counts = every[:, :1]
        means, m2s = every[:, 1:1 + c], every[:, 1 + c:]
        n = counts.sum()
        mean = (counts * means).sum(0) / n
        var = (m2s + counts * (means - mean) ** 2).sum(0) / n
        invstd = torch.rsqrt(var + eps)
        xc = xf - mean.view(view)
        out = (xc * invstd.view(view) * g.float().view(view)
               + beta.float().view(view)).to(x.dtype)
        ctx.save_for_backward(x, g, mean, invstd, n)
        ctx.all_reduce = all_reduce
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g, mean, invstd, n = ctx.saved_tensors
        dims = [0] + list(range(2, x.ndim))
        view = [1, -1] + [1] * (x.ndim - 2)
        xhat = (x.float() - mean.view(view)) * invstd.view(view)
        dyf = dy.float()
        sdy = dyf.sum(dims)
        sdyx = (dyf * xhat).sum(dims)
        both = torch.cat([sdy, sdyx])
        ctx.all_reduce(both)
        gsdy, gsdyx = both[:sdy.numel()], both[sdy.numel():]
        dx = (g.float() * invstd / n).view(view) * (
            n * dyf - gsdy.view(view) - xhat * gsdyx.view(view))
        return (dx.to(x.dtype),
                sdyx.to(g.dtype) if ctx.needs_input_grad[1] else None,
                sdy.to(g.dtype) if ctx.needs_input_grad[2] else None,
                None, None)


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
    moving mean/variance (biased batch variance) as trailing outputs.
    Integer data (uint8 raw pixels) is normalized in the parameters'
    float dtype, as the JAX package's promotes it."""
    if not data.is_floating_point():
        data = data.to(gamma.dtype)
    axis = axis % data.ndim
    x = data if axis == 1 else data.movedim(axis, 1)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    ops = getattr(_global_stats, "ops", None)
    if is_train and not use_global_stats and ops is not None:
        out, mean, var = _GlobalBatchNorm.apply(x, g, beta, eps, ops)
        with torch.no_grad():
            new_mean = moving_mean * momentum + mean.to(
                moving_mean.dtype) * (1 - momentum)
            new_var = moving_var * momentum + var.to(
                moving_var.dtype) * (1 - momentum)
    elif is_train and not use_global_stats:
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


# --------------------------------------------------------- softmax family
_SOFTMAX_COERCE = {"axis": coerce_int, "temperature": coerce_float}


@register("softmax", arg_names=["data"], coerce=_SOFTMAX_COERCE,
          defaults={"axis": -1, "temperature": 1.0})
def softmax(data, axis=-1, temperature=1.0):
    return torch.softmax(data / temperature, dim=axis)


@register("log_softmax", arg_names=["data"], coerce=_SOFTMAX_COERCE,
          defaults={"axis": -1, "temperature": 1.0})
def log_softmax(data, axis=-1, temperature=1.0):
    return torch.log_softmax(data / temperature, dim=axis)


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


@contextlib.contextmanager
def global_shapes(mapping):
    """Inside the block, a tensor whose shape is a key of `mapping`
    ({local shape: global shape}) is a slice of a tensor of the global
    shape: a fused step across processes that splits an input off its
    batch dimension (the sequence over 'seq') says so, and an op that
    normalizes by its label's size uses the global size
    (`global_shape`), as the JAX package's one program over the mesh
    does."""
    prev = getattr(_global_stats, "shapes", None)
    _global_stats.shapes = dict(mapping)
    try:
        yield
    finally:
        _global_stats.shapes = prev


def global_shape(t):
    """The global shape of `t` (its own outside `global_shapes`)."""
    shapes = getattr(_global_stats, "shapes", None) or {}
    return tuple(shapes.get(tuple(t.shape), t.shape))


class _RegressionOutput(torch.autograd.Function):
    """fwd(data) forward; backward grad_scale / prod(label.shape[1:]) *
    bwd(out, label), whatever the head gradient; the label gets none.
    The label's shape is its global shape (`global_shape`)."""

    @staticmethod
    def forward(ctx, data, label, fwd, bwd, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.bwd, ctx.grad_scale = bwd, grad_scale
        ctx.num_output = math.prod(global_shape(label)[1:])
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num_output = ctx.num_output
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


# ------------------------------------------------------- deconvolution
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _unflipped_conv_transpose(data, weight, stride, pad, adj, dilate):
    """lax.conv_transpose(..., transpose_kernel=False) with an IO weight
    and MXNet's output size, (in - 1) * stride - 2 * pad + dilate *
    (kernel - 1) + adj + 1: torch's transposed convolution of the
    spatially flipped weight."""
    nd = data.ndim - 2
    if any(a >= max(s, d) for a, s, d in zip(adj, stride, dilate)):
        raise MXNetError(f"Deconvolution: adj {tuple(adj)} must be smaller "
                         f"than stride {tuple(stride)}")
    return _CONV_T[nd](data, torch.flip(weight, tuple(range(2, nd + 2))),
                       stride=stride, padding=pad, output_padding=adj,
                       dilation=dilate)


@register("Deconvolution", arg_names=["data", "weight", "bias"],
          coerce={"kernel": coerce_tuple, "stride": coerce_tuple,
                  "dilate": coerce_tuple, "pad": coerce_tuple,
                  "adj": coerce_tuple, "target_shape": coerce_tuple,
                  "num_filter": coerce_int, "num_group": coerce_int,
                  "no_bias": coerce_bool},
          defaults={"num_group": 1, "no_bias": True})
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=0,
                  num_group=1, no_bias=True, workspace=512, cudnn_tune=None,
                  cudnn_off=False, layout=None):
    """Transposed convolution as the JAX package computes it, copied on
    purpose: the (C_in, C_out / num_group, k...) weight is applied
    without the spatial flip of a true transposed convolution, and
    num_group and target_shape are ignored (the output has the weight's
    second dimension as channels)."""
    nd = len(kernel)
    out = _unflipped_conv_transpose(
        data, weight, _spatial_tuple(stride, nd, 1),
        _spatial_tuple(pad, nd, 0),
        _spatial_tuple(adj, nd, 0) if adj else (0,) * nd,
        _spatial_tuple(dilate, nd, 1))
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# --------------------------------------------------- normalization layers
@register("InstanceNorm", arg_names=["data", "gamma", "beta"],
          coerce={"eps": coerce_float}, defaults={"eps": 1e-3})
def instance_norm(data, gamma, beta, eps=1e-3):
    axes = tuple(range(2, data.ndim))
    mean = data.mean(dim=axes, keepdim=True)
    var = torch.square(data - mean).mean(dim=axes, keepdim=True)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


_L2_AXES = {"instance": lambda nd: tuple(range(1, nd)),
            "channel": lambda nd: (1,),
            "spatial": lambda nd: tuple(range(2, nd))}


@register("L2Normalization", arg_names=["data"],
          coerce={"eps": coerce_float},
          defaults={"eps": 1e-10, "mode": "instance"})
def l2_normalization(data, eps=1e-10, mode="instance"):
    if mode not in _L2_AXES:
        raise MXNetError(f"unknown mode {mode!r}")
    axes = _L2_AXES[mode](data.ndim)
    return data / torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                       keepdim=True) + eps)


@register("LRN", arg_names=["data"],
          coerce={"alpha": coerce_float, "beta": coerce_float,
                  "knorm": coerce_float, "nsize": coerce_int},
          defaults={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0})
def lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels: the squares summed
    over a window of `nsize` channels, zero beyond the edges."""
    half = nsize // 2
    sq = torch.square(data).movedim(1, -1)
    padded = F.pad(sq, (half, half)).movedim(-1, 1)
    windows = sum(padded[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha / nsize * windows, beta)


@register("SoftmaxActivation", arg_names=["data"],
          defaults={"mode": "instance"})
def softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


# ---------------------------------------------------------- more heads
class _SVMOutput(torch.autograd.Function):
    """Identity forward; the hinge loss's gradient backward (L1 with
    use_linear, else squared), whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.params = (margin, reg_coef, use_linear)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.params
        hot = _onehot(label.to(torch.int64), data.shape[1], 1,
                      data.dtype) > 0
        sign = torch.where(hot, -1.0, 1.0).to(data.dtype)
        viol = (margin + sign * data) > 0
        grad = sign if use_linear else 2.0 * (margin + sign * data) * sign
        grad = torch.where(viol, grad, torch.zeros_like(grad))
        return grad * reg_coef, None, None, None, None


@register("SVMOutput", arg_names=["data", "label"],
          coerce={"margin": coerce_float,
                  "regularization_coefficient": coerce_float,
                  "use_linear": coerce_bool},
          defaults={"margin": 1.0, "regularization_coefficient": 1.0,
                    "use_linear": False},
          no_grad_inputs=("label",))
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


@register("softmax_cross_entropy", arg_names=["data", "label"],
          no_grad_inputs=("label",))
def softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, label.to(torch.int64)[:, None])
    return -torch.sum(picked).reshape((1,))


@register("IdentityAttachKLSparseReg", arg_names=["data"],
          coerce={"sparseness_target": coerce_float, "penalty": coerce_float,
                  "momentum": coerce_float},
          defaults={"sparseness_target": 0.1, "penalty": 0.001,
                    "momentum": 0.9})
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """The identity, with the identity's gradient, as in the JAX package
    (which keeps neither the reference MXNet's KL penalty gradient nor
    its moving-average state)."""
    return data


# ---------------------------------------------------------- sequence ops
def _along_time(data, idx):
    """data[idx[t, n], n, ...] (jnp.take_along_axis over axis 0 in its
    fill mode: a step past the end reads NaN)."""
    t = data.shape[0]
    ok = (idx >= 0) & (idx < t)
    full = idx.reshape(idx.shape + (1,) * (data.ndim - 2)).expand(
        (idx.shape[0],) + data.shape[1:])
    okf = ok.reshape(full.shape[:2] + (1,) * (data.ndim - 2))
    out = torch.gather(data, 0, torch.clamp(full, 0, t - 1))
    return torch.where(okf, out, torch.full((), float("nan"),
                                            dtype=data.dtype,
                                            device=data.device))


_SEQ_COERCE = {"use_sequence_length": coerce_bool}


@register("SequenceMask", arg_names=["data", "sequence_length"],
          coerce={"use_sequence_length": coerce_bool,
                  "value": coerce_float},
          defaults={"use_sequence_length": False, "value": 0.0},
          no_grad_inputs=("sequence_length",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0):
    """(T, N, ...) data with the steps at and past each sequence's
    length set to `value`."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[0], dtype=torch.float32,
                         device=data.device)[:, None]
    mask = (steps < sequence_length.to(torch.float32)[None, :]).to(
        data.dtype)
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return data * mask + value * (1 - mask)


@register("SequenceLast", arg_names=["data", "sequence_length"],
          coerce=_SEQ_COERCE, defaults={"use_sequence_length": False},
          no_grad_inputs=("sequence_length",))
def sequence_last(data, sequence_length=None, use_sequence_length=False):
    if not use_sequence_length or sequence_length is None:
        return data[-1]
    idx = torch.clamp_min(sequence_length.to(torch.int64) - 1, 0)
    return _along_time(data, idx[None, :])[0]


@register("SequenceReverse", arg_names=["data", "sequence_length"],
          coerce=_SEQ_COERCE, defaults={"use_sequence_length": False},
          no_grad_inputs=("sequence_length",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int64)[None, :]
    return _along_time(data, torch.where(steps < lens, lens - 1 - steps,
                                         steps))


# ------------------------------------------------------------ upsampling
@register("UpSampling",
          coerce={"scale": coerce_int, "num_filter": coerce_int,
                  "num_args": coerce_int},
          defaults={"sample_type": "nearest"})
def upsampling(*args, scale=2, sample_type="nearest", num_filter=0,
               num_args=None, multi_input_mode="concat", workspace=512):
    """nearest: each input repeated to the first one's scale, then
    concatenated on channels; bilinear: the Deconvolution of the data by
    the given (C_in, C_out, k, k) weight (k = 2·scale − scale % 2), the
    JAX package's unflipped form."""
    data = args[0]
    if sample_type == "nearest":
        def up(x, s):
            return torch.repeat_interleave(
                torch.repeat_interleave(x, s, dim=2), s, dim=3)

        out = up(data, scale)
        if len(args) == 1:
            return out
        return torch.cat([out] + [up(x, out.shape[2] // x.shape[2])
                                  for x in args[1:]], dim=1)
    if sample_type == "bilinear":
        k = 2 * scale - scale % 2
        p = (k - scale) // 2
        return _unflipped_conv_transpose(data, args[1], (scale, scale),
                                         (p, p), (0, 0), (1, 1))
    raise MXNetError(f"unknown sample_type {sample_type!r}")


# --------------------------------------------------------------- CTC loss
def _ctc_arg_names(params):
    names = ["data", "label"]
    if coerce_bool(params.get("use_data_lengths", False)):
        names.append("data_lengths")
    if coerce_bool(params.get("use_label_lengths", False)):
        names.append("label_lengths")
    return names


def _ctc_core(logits, logit_pads, labels, label_pads, blank_id,
              log_eps=-1e5):
    """optax.ctc_loss's log-alpha recursion, step for step: (N, T, C)
    unnormalized logits, (N, T) frame paddings, (N, L) right-padded
    labels with their (N, L) paddings; per-sequence loss (N,)."""
    n, _, c = logits.shape
    max_len = labels.shape[1]
    logp = torch.log_softmax(logits, dim=-1)
    lens = max_len - label_pads.sum(dim=1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logp.dtype), (0, 1))
    phi_lp = logp[:, :, blank_id].transpose(0, 1)[..., None]    # (T, N, 1)
    hot = F.one_hot(labels.to(torch.int64), c).to(logp.dtype)   # (N, L, C)
    emit_lp = torch.einsum("btk,bnk->tbn", logp, hot)           # (T, N, L)
    phi = torch.full((n, max_len + 1), log_eps, dtype=logp.dtype,
                     device=logp.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((n, max_len), log_eps, dtype=logp.dtype,
                      device=logp.device)

    def add_to_tail(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], 1)

    pads = logit_pads.transpose(0, 1)
    for t in range(logp.shape[1]):
        prev_phi = add_to_tail(phi, emit + log_eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + emit_lp[t],
                                    emit + emit_lp[t])
        next_phi = add_to_tail(prev_phi + phi_lp[t],
                               emit + phi_lp[t] + log_eps * (1.0 - repeat))
        pad = pads[t].reshape(n, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi + (1.0 - pad) * next_phi
    last = add_to_tail(phi, emit)
    return -torch.gather(last, 1, lens[:, None])[:, 0]


@register("CTCLoss", arg_names_fn=_ctc_arg_names,
          coerce={"use_data_lengths": coerce_bool,
                  "use_label_lengths": coerce_bool,
                  "blank_label": lambda v: str(v)},
          defaults={"use_data_lengths": False, "use_label_lengths": False,
                    "blank_label": "first"},
          no_grad_inputs=("label", "data_lengths", "label_lengths"),
          aliases=("ctc_loss", "WarpCTC"))
def ctc_loss(*inputs, use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC loss of (T, N, C) activations (softmax applied inside) against
    (N, L) labels, per example (N,). blank_label 'first': the blank is
    id 0 and label padding is 0; 'last': the blank is C - 1 and padding
    is any negative id. The optional (N,) lengths mask frames and
    labels past them."""
    if blank_label not in ("first", "last"):
        raise MXNetError(f"CTCLoss: blank_label must be 'first' or 'last', "
                         f"got {blank_label!r}")
    names = _ctc_arg_names({"use_data_lengths": use_data_lengths,
                            "use_label_lengths": use_label_lengths})
    if len(inputs) != len(names):
        raise MXNetError(f"CTCLoss: expected {len(names)} inputs "
                         f"({', '.join(names)}), got {len(inputs)}")
    given = dict(zip(names, inputs))
    data, label = given["data"], given["label"]
    t, n, c = data.shape
    logits = data.transpose(0, 1)
    if use_data_lengths:
        steps = torch.arange(t, dtype=torch.float32, device=data.device)
        logit_pads = (steps[None, :] >= given["data_lengths"].to(
            torch.float32).reshape(-1, 1)).to(logits.dtype)
    else:
        logit_pads = torch.zeros((n, t), dtype=logits.dtype,
                                 device=data.device)
    lab = label.to(torch.int32)
    blank_id = 0 if blank_label == "first" else c - 1
    pads = lab <= 0 if blank_label == "first" else lab < 0
    if use_label_lengths:
        pos = torch.arange(lab.shape[1], dtype=torch.int32,
                           device=data.device)
        pads = pads | (pos[None, :] >= given["label_lengths"].to(
            torch.int32).reshape(-1, 1))
    lab = torch.where(pads, blank_id, lab)
    return _ctc_core(logits, logit_pads, lab, pads.to(logits.dtype),
                     blank_id)
