"""The ported op library (mxnet_tpu_torch.ops) against the JAX package's
ops, at small shapes on the CPU.

Each case runs one registered op on the same numpy inputs in both
packages: the forward values, and the gradients of every differentiable
input for one random head gradient (jax.vjp against torch.autograd).
The loss heads (SoftmaxOutput, MakeLoss) carry MXNet's own gradient,
which ignores the head gradient. Every op of the fusion pass's
ELEMWISE_OPS and the codegen's REDUCE_OPS has a case: those are the
plain versions of the generated kernels.

Tolerances: float32 throughout. Pointwise ops agree to 1e-5 relative
(different libm implementations); convolution, pooling, BatchNorm and
the dense layer sum in other orders, and BatchNorm's JAX variance is
one-pass (E[x^2] - E[x]^2), so those agree to 1e-4 of the output's
magnitude.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu.ops  # noqa: E402,F401  (registers the JAX ops)
import mxnet_tpu_torch.ops  # noqa: E402,F401
from mxnet_tpu.ops import registry as jreg  # noqa: E402
from mxnet_tpu.passes.pallas_codegen import REDUCE_OPS as J_REDUCE  # noqa: E402
from mxnet_tpu.passes.transforms import ELEMWISE_OPS as J_ELEMWISE  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from mxnet_tpu_torch.passes import REDUCE_OPS, ELEMWISE_OPS  # noqa: E402

POINTWISE_RTOL = 1e-5
LAYER_RTOL = 1e-4


def _pos(rs, *shape):
    return rs.uniform(0.5, 1.5, shape).astype(np.float32)


def _randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _run_jax(name, ins, params, head, grad_mask, **kw):
    op = jreg.get(name)
    p = op.normalize_params(params)
    xs = [jnp.asarray(x) for x in ins]
    full = op.fn(*xs, **p, **kw)

    def f(*diff):
        it = iter(diff)
        args = [next(it) if m else x for x, m in zip(xs, grad_mask)]
        return _first(op.fn(*args, **p, **kw))

    _, vjp = jax.vjp(f, *[x for x, m in zip(xs, grad_mask) if m])
    grads = vjp(jnp.asarray(head))
    outs = full if isinstance(full, (tuple, list)) else (full,)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _run_torch(name, ins, params, head, grad_mask, **kw):
    op = treg.get(name)
    p = op.normalize_params(params)
    xs = [torch.from_numpy(np.array(x)).requires_grad_(bool(m))
          for x, m in zip(ins, grad_mask)]
    full = op.fn(*xs, **p, **kw)
    outs = full if isinstance(full, (tuple, list)) else (full,)
    wrt = [x for x, m in zip(xs, grad_mask) if m]
    grads = torch.autograd.grad(outs[0], wrt, torch.from_numpy(head),
                                allow_unused=True)
    grads = [np.zeros(x.shape, np.float32) if g is None
             else g.detach().numpy() for g, x in zip(grads, wrt)]
    return [o.detach().numpy() for o in outs], grads


def _compare(name, ins, params, rtol, grad_mask=None, seed=0, **kw):
    """Forward and input gradients of op `name` in both packages."""
    if grad_mask is None:
        grad_mask = [np.asarray(x).dtype.kind == "f" for x in ins]
    op = treg.get(name)
    probe = op.fn(*[torch.from_numpy(np.array(x)) for x in ins],
                  **op.normalize_params(params), **kw)
    head = np.asarray(np.random.RandomState(seed + 99).randn(
        *_first(probe).shape), np.float32)
    j_outs, j_grads = _run_jax(name, ins, params, head, grad_mask, **kw)
    t_outs, t_grads = _run_torch(name, ins, params, head, grad_mask, **kw)
    assert len(j_outs) == len(t_outs)
    for k, (a, b) in enumerate(zip(j_outs, t_outs)):
        assert a.shape == b.shape, (name, k, a.shape, b.shape)
        scale = max(float(np.abs(a).max()), 1.0)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{name} output {k}")
    for k, (a, b) in enumerate(zip(j_grads, t_grads)):
        scale = max(float(np.abs(a).max()), 1.0)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{name} gradient {k}")


# ------------------------------------------------------- pointwise ops
S = (4, 5)

_UNARY_POS = ("log", "sqrt", "rsqrt", "reciprocal", "log1p")
_UNARY = ("relu", "sigmoid", "tanh", "exp", "expm1", "square", "abs",
          "sign", "negative", "softsign", "erf", "identity", "_copy")
_BINARY = ("elemwise_add", "elemwise_sub", "elemwise_mul", "_maximum",
           "_minimum")
_BROADCAST = ("broadcast_add", "broadcast_sub", "broadcast_mul",
              "broadcast_maximum", "broadcast_minimum")
_SCALAR = ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
           "_mul_scalar", "_div_scalar", "_maximum_scalar",
           "_minimum_scalar")
_SCALAR_POS = ("_rdiv_scalar", "_power_scalar", "_rpower_scalar")


def _pointwise_cases():
    rs = np.random.RandomState(1)
    cases = []
    for op in _UNARY_POS:
        cases.append((op, [_pos(rs, *S)], {}))
    for op in _UNARY:
        cases.append((op, [_randn(rs, *S)], {}))
    for op in _BINARY:
        cases.append((op, [_randn(rs, *S), _randn(rs, *S)], {}))
    for op in _BROADCAST:
        cases.append((op, [_randn(rs, *S), _randn(rs, 1, 5)], {}))
    cases.append(("elemwise_div", [_randn(rs, *S), _pos(rs, *S)], {}))
    cases.append(("broadcast_div", [_randn(rs, *S), _pos(rs, 4, 1)], {}))
    cases.append(("_power", [_pos(rs, *S), _randn(rs, *S)], {}))
    cases.append(("broadcast_power", [_pos(rs, *S), _randn(rs, 1, 5)], {}))
    sign = np.where(rs.rand(*S) < 0.5, -1.0, 1.0).astype(np.float32)
    cases.append(("_mod", [3 * _randn(rs, *S), sign * _pos(rs, *S)], {}))
    for op in _SCALAR:
        cases.append((op, [_randn(rs, *S)], {"scalar": 0.7}))
    for op in _SCALAR_POS:
        cases.append((op, [_pos(rs, *S)], {"scalar": 1.3}))
    cases.append(("clip", [_randn(rs, *S)], {"a_min": -0.5, "a_max": 0.5}))
    cases.append(("cast", [_randn(rs, *S)], {"dtype": "float32"}))
    for act in ("relu", "sigmoid", "tanh", "softrelu"):
        cases.append(("Activation", [_randn(rs, *S)], {"act_type": act}))
    for scalar in (1.0, 2.0):
        cases.append(("smooth_l1", [_randn(rs, *S)], {"scalar": scalar}))
    for act in ("leaky", "elu"):
        cases.append(("LeakyReLU", [_randn(rs, 2, 3, 4)],
                      {"act_type": act, "slope": 0.3}))
    cases.append(("LeakyReLU", [_randn(rs, 2, 3, 4), _pos(rs, 3)],
                  {"act_type": "prelu"}))
    return cases


POINTWISE = _pointwise_cases()


def test_elemwise_and_reduce_sets_match_jax():
    assert ELEMWISE_OPS == J_ELEMWISE
    assert REDUCE_OPS == J_REDUCE


def test_every_elemwise_op_has_a_case():
    assert {c[0] for c in POINTWISE} == set(ELEMWISE_OPS)


@pytest.mark.parametrize(
    "name,ins,params", POINTWISE,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(POINTWISE)])
def test_pointwise_op(name, ins, params):
    kw = {}
    od = treg.get(name)
    if od.needs_mode:
        kw["is_train"] = False
    if od.needs_rng:
        kw["rng"] = None
    _compare(name, ins, params, POINTWISE_RTOL, **kw)


# ------------------------------------------------------------ reductions
_REDUCE_PARAMS = [{}, {"axis": 1}, {"axis": (0, 2), "keepdims": True},
                  {"axis": 1, "exclude": True}]


@pytest.mark.parametrize("op", sorted(REDUCE_OPS))
@pytest.mark.parametrize("params", _REDUCE_PARAMS,
                         ids=["full", "axis1", "axis02_keep", "exclude1"])
def test_reduce_op(op, params):
    x = np.random.RandomState(2).randn(3, 4, 5).astype(np.float32)
    _compare(op, [x], params, POINTWISE_RTOL)


# ----------------------------------------------------------- layer ops
def _conv_case(rs, c_in, c_out, k, groups=1, **params):
    x = _randn(rs, 2, c_in, 9, 8)
    w = _randn(rs, c_out, c_in // groups, *k) * 0.3
    ins = [x, w]
    if not params.get("no_bias"):
        ins.append(_randn(rs, c_out))
    params.update(kernel=k, num_filter=c_out, num_group=groups)
    return ins, params


_CONV = {
    "3x3": dict(c_in=3, c_out=4, k=(3, 3)),
    "stride2_pad1": dict(c_in=3, c_out=4, k=(3, 3), stride=(2, 2),
                         pad=(1, 1)),
    "dilate2": dict(c_in=3, c_out=4, k=(3, 3), dilate=(2, 2)),
    "groups3_nobias": dict(c_in=6, c_out=6, k=(3, 3), groups=3,
                           no_bias=True),
    "1x7_pad": dict(c_in=4, c_out=5, k=(1, 7), pad=(0, 3), no_bias=True),
    "7x1_pad": dict(c_in=4, c_out=5, k=(7, 1), pad=(3, 0), no_bias=True),
}


@pytest.mark.parametrize("case", sorted(_CONV))
def test_convolution(case):
    ins, params = _conv_case(np.random.RandomState(3), **dict(_CONV[case]))
    _compare("Convolution", ins, params, LAYER_RTOL)


_POOL = {
    "max3s2": dict(kernel=(3, 3), stride=(2, 2), pool_type="max"),
    "max3s2_pad1": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="max"),
    "avg3s1_pad1": dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        pool_type="avg"),
    "avg3s2_full": dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
                        pooling_convention="full"),
    "max3s2_full": dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
                        pooling_convention="full"),
    "sum2s2": dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"),
    "avg2_pad2": dict(kernel=(2, 2), stride=(1, 1), pad=(2, 2),
                      pool_type="avg"),
    "global_avg": dict(kernel=(1, 1), global_pool=True, pool_type="avg"),
    "global_max": dict(kernel=(1, 1), global_pool=True, pool_type="max"),
}


@pytest.mark.parametrize("case", sorted(_POOL))
def test_pooling(case):
    x = np.random.RandomState(4).randn(2, 3, 9, 8).astype(np.float32)
    _compare("Pooling", [x], dict(_POOL[case]), LAYER_RTOL)


def _bn_ins(rs):
    c = 3
    return [_randn(rs, 4, c, 5, 5) * 2 + 0.5, _pos(rs, c), _randn(rs, c),
            _randn(rs, c) * 0.1, _pos(rs, c)]


_BN_MASK = [True, True, True, False, False]


@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_train_with_aux_update(fix_gamma):
    """Training mode: the normalized output, then the updated moving
    mean and variance (trailing outputs), and the gradients of data,
    gamma (zero under fix_gamma) and beta."""
    params = {"fix_gamma": fix_gamma, "eps": 2e-5, "momentum": 0.9}
    _compare("BatchNorm", _bn_ins(np.random.RandomState(5)), params,
             LAYER_RTOL, grad_mask=_BN_MASK, is_train=True)


def test_batchnorm_train_output_shapes():
    ins = [torch.from_numpy(x) for x in _bn_ins(np.random.RandomState(5))]
    outs = treg.get("BatchNorm").fn(*ins, is_train=True)
    assert [tuple(o.shape) for o in outs] == [(4, 3, 5, 5), (3,), (3,)]


@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_inference(fix_gamma):
    _compare("BatchNorm", _bn_ins(np.random.RandomState(6)),
             {"fix_gamma": fix_gamma, "eps": 1e-3}, LAYER_RTOL,
             grad_mask=_BN_MASK, is_train=False)


@pytest.mark.parametrize("flatten,no_bias", [(True, False), (False, False),
                                             (True, True)])
def test_fully_connected(flatten, no_bias):
    rs = np.random.RandomState(7)
    x = _randn(rs, 3, 4, 5)
    d = 20 if flatten else 5
    ins = [x, _randn(rs, 6, d)] + ([] if no_bias else [_randn(rs, 6)])
    _compare("FullyConnected", ins, {"num_hidden": 6, "flatten": flatten,
                                     "no_bias": no_bias}, LAYER_RTOL)


def test_concat():
    rs = np.random.RandomState(8)
    ins = [_randn(rs, 2, c, 3, 3) for c in (2, 3, 1)]
    _compare("Concat", ins, {"dim": 1, "num_args": 3}, POINTWISE_RTOL)


def test_flatten():
    _compare("flatten", [_randn(np.random.RandomState(9), 2, 3, 4, 5)], {},
             POINTWISE_RTOL)


@pytest.mark.parametrize("shape", [(0, -1), (-1, 5), (2, -3, 5)])
def test_reshape(shape):
    _compare("reshape", [_randn(np.random.RandomState(10), 2, 3, 4, 5)],
             {"shape": shape}, POINTWISE_RTOL)


# ----------------------------------------------------------- loss heads
_SOFTMAX = {
    "null": {},
    "batch_scaled": {"normalization": "batch", "grad_scale": 0.5},
    "valid_ignore": {"normalization": "valid", "use_ignore": True,
                     "ignore_label": 2},
    "smooth": {"smooth_alpha": 0.1},
}


@pytest.mark.parametrize("case", sorted(_SOFTMAX))
def test_softmax_output_gradient(case):
    """Forward is the softmax; the data gradient is MXNet's
    (prob - onehot) with its scale and normalization, whatever the head
    gradient."""
    rs = np.random.RandomState(11)
    data = _randn(rs, 6, 5)
    label = np.array([0, 2, 4, 2, 1, 3], np.float32)
    _compare("SoftmaxOutput", [data, label], dict(_SOFTMAX[case]),
             POINTWISE_RTOL, grad_mask=[True, False])


def test_softmax_output_multi_output_gradient():
    rs = np.random.RandomState(12)
    data = _randn(rs, 2, 3, 4)
    label = rs.randint(0, 3, (2, 4)).astype(np.float32)
    _compare("SoftmaxOutput", [data, label],
             {"multi_output": True, "normalization": "valid"},
             POINTWISE_RTOL, grad_mask=[True, False])


@pytest.mark.parametrize("params", [{}, {"grad_scale": 0.3,
                                         "normalization": "batch"}])
def test_make_loss_gradient(params):
    _compare("MakeLoss", [_randn(np.random.RandomState(13), 4, 3)],
             params, POINTWISE_RTOL)


# --------------------------------------------------------------- dropout
def test_dropout_p0_is_identity():
    x = _randn(np.random.RandomState(14), 64, 33)
    gen = torch.Generator().manual_seed(0)
    out = treg.get("Dropout").fn(torch.from_numpy(x), p=0.0, rng=gen,
                                 is_train=True)
    j = jreg.get("Dropout").fn(jnp.asarray(x), p=0.0,
                               rng=jax.random.PRNGKey(0), is_train=True)
    np.testing.assert_array_equal(out.numpy(), x)
    np.testing.assert_array_equal(np.asarray(j), x)


def test_dropout_keep_rate_and_scale():
    """p=0.5: the kept share is 1/2 within 5 standard deviations in both
    packages (their random bits differ), kept values are doubled, and
    inference is the identity."""
    x = np.ones((200, 500), np.float32)
    n = x.size
    sd = np.sqrt(0.25 / n)
    gen = torch.Generator().manual_seed(1)
    t = treg.get("Dropout").fn(torch.from_numpy(x), p=0.5, rng=gen,
                               is_train=True).numpy()
    j = np.asarray(jreg.get("Dropout").fn(
        jnp.asarray(x), p=0.5, rng=jax.random.PRNGKey(1), is_train=True))
    for out in (t, j):
        assert set(np.unique(out)) <= {0.0, 2.0}
        assert abs((out > 0).mean() - 0.5) < 5 * sd
    assert abs((t > 0).mean() - (j > 0).mean()) < 10 * sd
    ident = treg.get("Dropout").fn(torch.from_numpy(x), p=0.5, rng=gen,
                                   is_train=False)
    np.testing.assert_array_equal(ident.numpy(), x)
