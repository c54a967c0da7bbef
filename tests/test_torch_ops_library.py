"""The op library's slice of the port (ROADMAP.md A.2 but the vision
ops) against the JAX package's ops, on the CPU.

- Every op this slice registers: forward values and the gradients of
  every differentiable input for one random head gradient on each float
  output (jax.vjp against torch.autograd), from
  tests/test_torch_ndarray.py's LIBRARY_RECIPES and the variants below.
- The reference behaviours the port copies on purpose: Deconvolution's
  unflipped kernel and ignored num_group, Embedding's jnp.take ids (-1,
  input_dim, 1.7), Γ(-0.5) = +3.5449, round's halves to even, and the
  tie orders of sort, argsort and topk.
- The samplers: uniform, normal and exponential bit for bit, and gamma, poisson and the negative binomials by a
  two-sample KS test and their first two moments.
- The RNN op in every mode against the JAX op, and its blob layout
  against init.FusedRNN's.

Tolerances: pointwise ops 1e-5 relative (different libm); layers,
recurrences and reductions 1e-4 of each tensor's largest magnitude
(other summation orders).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402
from test_torch_ndarray import LIBRARY_RECIPES, _ctc, _randn, _rnn  # noqa: E402

POINTWISE_RTOL = 1e-5
LAYER_RTOL = 1e-4

# the canonical ops the port registered before this slice
PRIOR_OPS = frozenset((
    'Activation', 'BatchNorm', 'Concat', 'Convolution', 'Custom', 'Dropout',
    'FullyConnected', 'LeakyReLU', 'LinearRegressionOutput',
    'LogisticRegressionOutput', 'MAERegressionOutput', 'MakeLoss',
    'Pooling', 'RingAttention', 'SliceChannel', 'SoftmaxOutput', '_copy',
    '_div_scalar', '_equal', '_equal_scalar', '_graph_constant', '_greater',
    '_greater_equal', '_greater_equal_scalar', '_greater_scalar', '_lesser',
    '_lesser_equal', '_lesser_equal_scalar', '_lesser_scalar', '_maximum',
    '_maximum_scalar', '_minimum', '_minimum_scalar', '_minus_scalar',
    '_mod', '_mod_scalar', '_mul_scalar', '_not_equal', '_not_equal_scalar',
    '_ones', '_plus_scalar', '_power', '_power_scalar', '_rdiv_scalar',
    '_rminus_scalar', '_rmod_scalar', '_rpower_scalar', '_zeros', 'abs',
    'adam_update', 'broadcast_add', 'broadcast_div', 'broadcast_maximum',
    'broadcast_minimum', 'broadcast_mul', 'broadcast_power',
    'broadcast_sub', 'cast', 'clip', 'dot', 'elemwise_add', 'elemwise_div',
    'elemwise_mul', 'elemwise_sub', 'erf', 'exp', 'expand_dims', 'expm1',
    'flatten', 'identity', 'log', 'log1p', 'log_softmax', 'max', 'mean',
    'min', 'negative', 'pick', 'reciprocal', 'relu', 'reshape',
    'rmsprop_update', 'rmspropalex_update', 'rsqrt', 'sgd_mom_update',
    'sgd_update', 'sigmoid', 'sign', 'smooth_l1', 'softmax', 'softsign',
    'sqrt', 'square', 'sum', 'tanh', 'transpose'))
SAMPLERS = ("_random_uniform", "_random_normal", "_random_exponential",
            "_random_gamma", "_random_poisson", "_random_negative_binomial",
            "_random_generalized_negative_binomial")
SOURCES = ("_arange", "_full")
# reductions, layers and recurrences sum in other orders than XLA
LAYER_OPS = frozenset((
    "prod", "nanprod", "nansum", "norm", "batch_dot", "Deconvolution",
    "InstanceNorm", "L2Normalization", "LRN", "SoftmaxActivation",
    "softmax_cross_entropy", "CTCLoss", "RNN", "UpSampling", "add_n",
    "gamma", "erfinv"))


def _canonical_ops():
    return {op.name for op in treg._REGISTRY.values()}


def _float_outputs(outs):
    return [i for i, o in enumerate(outs)
            if np.asarray(o).dtype.kind == "f"]


def _run_jax(name, ins, params, heads, grad_mask, is_train):
    op = jreg.get(name)
    p = op.normalize_params(params)
    kw = {}
    if op.needs_rng:
        kw["rng"] = jax.random.PRNGKey(0)
    if op.needs_mode:
        kw["is_train"] = is_train
    xs = [jnp.asarray(x) for x in ins]

    def f(*diff):
        it = iter(diff)
        args = [next(it) if m else x for x, m in zip(xs, grad_mask)]
        out = op.fn(*args, **p, **kw)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    outs, vjp = jax.vjp(f, *[x for x, m in zip(xs, grad_mask) if m])
    grads = vjp(tuple(jnp.asarray(h) for h in heads)) if any(grad_mask) \
        else ()
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _run_torch(name, ins, params, heads, grad_mask, is_train):
    op = treg.get(name)
    p = op.normalize_params(params)
    kw = {}
    if op.needs_rng:
        kw["rng"] = None
    if op.needs_mode:
        kw["is_train"] = is_train
    xs = [torch.from_numpy(np.array(x)).requires_grad_(bool(m))
          for x, m in zip(ins, grad_mask)]
    out = op.fn(*xs, **p, **kw)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    wrt = [x for x, m in zip(xs, grad_mask) if m]
    pairs = [(o, torch.from_numpy(h)) for o, h in zip(outs, heads)
             if o.requires_grad]
    grads = [None] * len(wrt)
    if pairs and wrt:
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    wrt, [h for _, h in pairs],
                                    allow_unused=True)
    grads = [np.zeros(x.shape, np.float32) if g is None
             else g.detach().numpy() for g, x in zip(grads, wrt)]
    return [o.detach().numpy() for o in outs], grads


def compare(name, ins, params, rtol, seed=0, is_train=False):
    """Forward and input gradients of op `name` in both packages; the
    gradient of every float input outside the op's no_grad_inputs, for
    a random head gradient on each float output."""
    op = treg.get(name)
    names = op.arg_names_fn(op.normalize_params(params)) \
        if op.arg_names_fn else op.arg_names
    names = names or [f"arg{i}" for i in range(len(ins))]
    grad_mask = [np.asarray(x).dtype.kind == "f"
                 and n not in op.no_grad_inputs
                 for x, n in zip(ins, names)]
    probe, _ = _run_torch(name, ins, params, [], [False] * len(ins),
                          is_train)
    rs = np.random.RandomState(seed + 99)
    heads = [np.asarray(rs.randn(*o.shape), np.float32)
             if i in _float_outputs(probe) else np.zeros(o.shape, o.dtype)
             for i, o in enumerate(probe)]
    j_outs, j_grads = _run_jax(name, ins, params, heads, grad_mask,
                               is_train)
    t_outs, t_grads = _run_torch(name, ins, params, heads, grad_mask,
                                 is_train)
    assert len(j_outs) == len(t_outs), name
    for k, (a, b) in enumerate(zip(j_outs, t_outs)):
        assert a.shape == b.shape, (name, k, a.shape, b.shape)
        scale = max(float(np.nanmax(np.abs(a), initial=0.0)), 1.0)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{name} output {k}")
    for k, (a, b) in enumerate(zip(j_grads, t_grads)):
        scale = max(float(np.nanmax(np.abs(a), initial=0.0)), 1.0)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{name} gradient {k}")


# ------------------------------------------------- every op of the slice
GRAD_OPS = sorted(set(LIBRARY_RECIPES) - set(SAMPLERS) - set(SOURCES))


def test_every_op_of_the_slice_has_a_recipe():
    """Each canonical op the port registers beyond the earlier slices
    the vision ops (tests/test_torch_vision.py) and the parallel ops
    (MoEFFN: tests/test_torch_pipeline_moe.py) has a recipe, and the
    port refuses no op name of the JAX package."""
    vision = {op.name for op in treg._REGISTRY.values()
              if op.fn.__module__ == "mxnet_tpu_torch.ops.vision"}
    parallel = {op.name for op in treg._REGISTRY.values()
                if op.fn.__module__ == "mxnet_tpu_torch.ops.parallel_ops"}
    new = _canonical_ops() - PRIOR_OPS - vision - parallel
    assert new == set(LIBRARY_RECIPES) | set(SAMPLERS)
    refused = set(jreg.list_ops()) - set(treg.list_ops())
    assert refused == set()
    assert len(vision) == 14
    assert parallel == {"RingAttention", "MoEFFN"}


@pytest.mark.parametrize("name", GRAD_OPS)
def test_op_forward_and_gradient_match_jax(name):
    rs = np.random.RandomState(abs(hash(name)) % 2**31)
    ins, params = LIBRARY_RECIPES[name](rs)
    compare(name, ins, params,
            LAYER_RTOL if name in LAYER_OPS else POINTWISE_RTOL)


def _deconv(stride, pad, adj, dilate, nd=2, bias=True, groups=1):
    def recipe(rs):
        k = (3,) * nd
        sp = (5, 4, 6)[:nd]
        return ([_randn(rs, 2, 4, *sp), _randn(rs, 4, 3, *k) * 0.3,
                 _randn(rs, 3 * groups)],
                {"kernel": k, "stride": (stride,) * nd, "pad": (pad,) * nd,
                 "adj": (adj,) * nd, "dilate": (dilate,) * nd,
                 "num_filter": 3 * groups, "num_group": groups,
                 "no_bias": not bias})
    return recipe


def _pad(mode):
    return lambda rs: ([_randn(rs, 2, 3, 4, 5)],
                       {"mode": mode, "constant_value": 0.5,
                        "pad_width": (0, 1, 0, 0, 2, 5, 3, 1)})


VARIANTS = {
    "RNN-gru": ("RNN", _rnn("gru")),
    "RNN-rnn_tanh": ("RNN", _rnn("rnn_tanh")),
    "RNN-rnn_relu": ("RNN", _rnn("rnn_relu")),
    "RNN-lstm-bidirectional": ("RNN", _rnn("lstm", bidirectional=True)),
    "RNN-gru-bidirectional": ("RNN", _rnn("gru", bidirectional=True,
                                          layers=1)),
    "RNN-lstm-no-state-outputs": ("RNN", _rnn("lstm", state_outputs=False)),
    "RNN-lstm-batch-1-states": ("RNN", _rnn("lstm", batch_one_state=True)),
    "RNN-rnn_tanh-batch-1-bidirectional": (
        "RNN", _rnn("rnn_tanh", bidirectional=True, batch_one_state=True)),
    "CTCLoss-last": ("CTCLoss", _ctc("last")),
    "CTCLoss-lengths": ("CTCLoss", _ctc("first", lengths=True)),
    "CTCLoss-last-lengths": ("CTCLoss", _ctc("last", lengths=True)),
    "Deconvolution-1d": ("Deconvolution", _deconv(2, 1, 1, 1, nd=1)),
    "Deconvolution-3d-dilated": ("Deconvolution",
                                 _deconv(1, 2, 0, 2, nd=3, bias=False)),
    "Deconvolution-groups": ("Deconvolution", _deconv(2, 0, 0, 1,
                                                      bias=False,
                                                      groups=2)),
    "Pad-constant": ("Pad", _pad("constant")),
    "Pad-edge": ("Pad", _pad("edge")),
    "UpSampling-bilinear": ("UpSampling", lambda rs: (
        [_randn(rs, 2, 3, 4, 4), _randn(rs, 3, 3, 4, 4) * 0.2],
        {"scale": 2, "sample_type": "bilinear", "num_filter": 3,
         "num_args": 2})),
    "UpSampling-one-input": ("UpSampling", lambda rs: (
        [_randn(rs, 2, 3, 4, 4)], {"scale": 3, "num_args": 1})),
    "SoftmaxActivation-instance": ("SoftmaxActivation", lambda rs: (
        [_randn(rs, 2, 3, 4)], {})),
    "L2Normalization-instance": ("L2Normalization", lambda rs: (
        [_randn(rs, 2, 3, 4)], {})),
    "L2Normalization-channel": ("L2Normalization", lambda rs: (
        [_randn(rs, 2, 3, 4)], {"mode": "channel"})),
    "SVMOutput-linear": ("SVMOutput", lambda rs: (
        [_randn(rs, 4, 5), rs.randint(0, 5, 4).astype(np.float32)],
        {"margin": 1.5, "regularization_coefficient": 0.5,
         "use_linear": True})),
    "Sequence-last-no-lengths": ("SequenceLast", lambda rs: (
        [_randn(rs, 5, 3, 4)], {})),
    "SequenceReverse-long-lengths": ("SequenceReverse", lambda rs: (
        [_randn(rs, 4, 3, 2), np.array([4, 6, 1], np.float32)],
        {"use_sequence_length": True})),
    "SequenceLast-long-lengths": ("SequenceLast", lambda rs: (
        [_randn(rs, 4, 3, 2), np.array([4, 6, 0], np.float32)],
        {"use_sequence_length": True})),
    "take-clip": ("take", lambda rs: (
        [_randn(rs, 4, 5), np.array([[0, 6], [-2, 3]], np.float32)], {})),
    "take-fill": ("take", lambda rs: (
        [_randn(rs, 4, 5), np.array([[0, 6], [-2, 3]], np.float32)],
        {"mode": "raise"})),
    "where-full": ("where", lambda rs: (
        [rs.randint(0, 2, (3, 4)).astype(np.float32), _randn(rs, 3, 4),
         _randn(rs, 3, 4)], {})),
    "sort-ascend-flat": ("sort", lambda rs: (
        [rs.randn(3, 4).astype(np.float32)], {"axis": None})),
    "argsort-ascend": ("argsort", lambda rs: (
        [rs.randint(0, 3, (3, 5)).astype(np.float32)], {})),
    "topk-value-ascend": ("topk", lambda rs: (
        [rs.randn(3, 6).astype(np.float32)],
        {"k": 2, "ret_typ": "value", "is_ascend": True})),
    "topk-mask": ("topk", lambda rs: (
        [rs.randint(0, 3, (3, 6)).astype(np.float32)],
        {"k": 2, "ret_typ": "mask", "axis": 0})),
    "topk-indices-flat": ("topk", lambda rs: (
        [rs.randint(0, 3, (3, 6)).astype(np.float32)],
        {"k": 4, "axis": None})),
    "repeat-axis": ("repeat", lambda rs: (
        [_randn(rs, 3, 4)], {"repeats": 3, "axis": -1})),
    "Crop-offset": ("Crop", lambda rs: (
        [_randn(rs, 2, 3, 6, 7)], {"h_w": (3, 4), "offset": (2, 1),
                                   "num_args": 1})),
    "prod-all": ("prod", lambda rs: ([rs.uniform(0.5, 1.5, (3, 4)).astype(
        np.float32)], {})),
    "argmax-flat": ("argmax", lambda rs: (
        [rs.randint(0, 3, (3, 4)).astype(np.float32)], {})),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_op_variant_matches_jax(variant):
    name, recipe = VARIANTS[variant]
    ins, params = recipe(np.random.RandomState(len(variant)))
    compare(name, ins, params,
            LAYER_RTOL if name in LAYER_OPS else POINTWISE_RTOL)


@pytest.mark.parametrize("name", SOURCES)
def test_source_matches_jax(name):
    ins, params = LIBRARY_RECIPES[name](None)
    j = np.asarray(jreg.get(name).fn(**jreg.get(name).normalize_params(
        params)))
    t = treg.get(name).fn(**treg.get(name).normalize_params(params))
    assert str(t.dtype).endswith(str(j.dtype))
    np.testing.assert_array_equal(t.numpy(), j)


def test_rnn_dropout_between_layers_only():
    """In training with p > 0 the mask falls between layers: a
    one-layer net ignores p, a two-layer one differs from p = 0."""
    rs = np.random.RandomState(3)
    ins, params = _rnn("lstm", layers=1)(rs)
    op = treg.get("RNN")
    xs = [torch.from_numpy(x) for x in ins]
    gen = torch.Generator().manual_seed(0)
    base = op.fn(*xs, **op.normalize_params(params), rng=gen,
                 is_train=False)
    drop = op.fn(*xs, **op.normalize_params(dict(params, p=0.5)), rng=gen,
                 is_train=True)
    for a, b in zip(base, drop):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ins, params = _rnn("lstm", layers=2)(rs)
    xs = [torch.from_numpy(x) for x in ins]
    base = op.fn(*xs, **op.normalize_params(params), rng=gen,
                 is_train=True)[0]
    drop = op.fn(*xs, **op.normalize_params(dict(params, p=0.5)), rng=gen,
                 is_train=True)[0]
    assert drop.shape == base.shape and torch.isfinite(drop).all()
    assert not torch.equal(drop, base)


def test_rnn_layout_is_init_fused_rnns():
    """init.FusedRNN's gate blocks are the op's views: the forget gate's
    biases (the second block of each i2h and h2h bias) are forget_bias
    and the other biases 0, in both packages, bit for bit."""
    from mxnet_tpu_torch.ops.rnn_op import layer_weights, param_layout

    h, layers, size_in = 3, 2, 4
    entries, total = param_layout(size_in, h, layers, True, "lstm")
    blobs = []
    for mx in (jmx, tmx):
        mx.random.seed(5)
        arr = mx.nd.zeros((total,), ctx=mx.cpu())
        mx.init.FusedRNN(mx.init.Uniform(0.1), h, layers, "lstm", True,
                         forget_bias=2.5)("lstm_parameters", arr)
        blobs.append(arr.asnumpy())
    np.testing.assert_array_equal(blobs[0], blobs[1])
    blob = torch.from_numpy(blobs[1])
    for layer in range(layers):
        for d in range(2):
            _, _, b_ih, b_hh = layer_weights(blob, entries, layer, d)
            for b in (b_ih, b_hh):
                assert torch.all(b[h:2 * h] == 2.5)
                assert torch.all(b[:h] == 0) and torch.all(b[2 * h:] == 0)


# ------------------------------------------------ copied quirks, stated
def test_deconvolution_does_not_flip_its_kernel():
    """The JAX package's Deconvolution differs from a true transposed
    convolution by O(1) and equals the flipped kernel's to rounding;
    the port gives the JAX package's."""
    rs = np.random.RandomState(0)
    x, w = _randn(rs, 2, 3, 5, 5), _randn(rs, 3, 4, 3, 3)
    params = {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "adj": (1, 1), "num_filter": 4}
    j = np.asarray(jreg.get("Deconvolution").fn(
        jnp.asarray(x), jnp.asarray(w),
        **jreg.get("Deconvolution").normalize_params(params)))
    t = tmx.nd.Deconvolution(tmx.nd.array(x, ctx=tmx.cpu()),
                             tmx.nd.array(w, ctx=tmx.cpu()),
                             **params).asnumpy()
    conv_t = torch.nn.functional.conv_transpose2d
    true = conv_t(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                  padding=1, output_padding=1).numpy()
    flipped = conv_t(torch.from_numpy(x), torch.from_numpy(w).flip(-1, -2),
                     stride=2, padding=1, output_padding=1).numpy()
    assert np.abs(j - true).max() > 1.0
    np.testing.assert_allclose(flipped, j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_deconvolution_ignores_num_group():
    """num_group=2, num_filter=6: the inferred weight is (4, 3, 3, 3) and
    the output has 3 channels, in both packages."""
    shapes = []
    for mx in (jmx, tmx):
        net = mx.sym.Deconvolution(mx.sym.Variable("data"), kernel=(3, 3),
                                   num_filter=6, num_group=2, name="dc")
        args, outs, _ = net.infer_shape(data=(2, 4, 5, 5))
        shapes.append((args, outs))
    assert shapes[0] == shapes[1]
    assert shapes[1][0][1] == (4, 3, 3, 3)
    assert shapes[1][1][0] == (2, 3, 7, 7)


def test_embedding_reads_like_jnp_take():
    """Float ids truncate (1.7 -> 1, -1.7 -> -1), -1 reads the last row,
    ids >= input_dim or < -input_dim read NaN; the weight gradient
    reaches only the rows read."""
    w = np.arange(15, dtype=np.float32).reshape(5, 3)
    ids = np.array([1.7, -1, 5, -6, -1.7], np.float32)
    outs = []
    for mx in (jmx, tmx):
        with mx.cpu():
            outs.append(mx.nd.Embedding(mx.nd.array(ids), mx.nd.array(w),
                                        input_dim=5, output_dim=3)
                        .asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1][0], w[1])
    np.testing.assert_array_equal(outs[1][1], w[4])
    np.testing.assert_array_equal(outs[1][4], w[4])
    assert np.isnan(outs[1][2:4]).all()
    wt = torch.from_numpy(w).requires_grad_(True)
    treg.get("Embedding").fn(torch.from_numpy(ids), wt).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy()[:, 0], [0, 1, 0, 0, 2])


def test_gamma_is_exp_lgamma():
    """gamma(x) = exp(lgamma(x)), so negative where Γ is negative it is
    positive: Γ(-0.5) = +3.5449 (the true value is -3.5449)."""
    x = np.array([-0.5, 0.5, 2.5, -1.5], np.float32)
    for mx in (jmx, tmx):
        with mx.cpu():
            got = mx.nd.gamma(mx.nd.array(x)).asnumpy()
        np.testing.assert_allclose(got[0], 3.5449077, rtol=1e-6)
        np.testing.assert_allclose(got[3], 2.3632718, rtol=1e-6)


def test_round_halves_to_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    for name in ("round", "rint"):
        got = [mx.nd.__dict__[name](mx.nd.array(x, ctx=mx.cpu())).asnumpy()
               for mx in (jmx, tmx)]
        np.testing.assert_array_equal(got[1], got[0])
        np.testing.assert_array_equal(got[1], [-2, -2, -0, 0, 2, 2, 4])


def test_tie_orders():
    """Among equal values: a descending sort/argsort puts the higher
    index first, topk the lower one (also with is_ascend)."""
    x = np.array([[1, 3, 1, 3, 2, 1]], np.float32)
    cases = [("argsort", {"is_ascend": False}, [[3, 1, 4, 5, 2, 0]]),
             ("argsort", {}, [[0, 2, 5, 4, 1, 3]]),
             ("topk", {"k": 3}, [[1, 3, 4]]),
             ("topk", {"k": 4, "is_ascend": True}, [[0, 2, 5, 4]])]
    for name, params, want in cases:
        got = []
        for mx in (jmx, tmx):
            with mx.cpu():
                got.append(getattr(mx.nd, name)(mx.nd.array(x), **params)
                           .asnumpy())
        np.testing.assert_array_equal(got[0], want, err_msg=name)
        np.testing.assert_array_equal(got[1], want, err_msg=name)


# ------------------------------------------------------------- samplers
def _draw(mx, name, seed, **params):
    mx.random.seed(seed)
    with mx.cpu():
        return getattr(mx.nd, name)(**params).asnumpy()


@pytest.mark.parametrize("name,params", [
    ("uniform", {"shape": (1000,)}),
    ("uniform", {"low": -3.0, "high": 0.5, "shape": (50, 40)}),
    ("_random_uniform", {"low": 1.0, "high": 1.7, "shape": (3, 7)})])
def test_uniform_is_bit_identical(name, params):
    j, t = (_draw(mx, name, 11, **params) for mx in (jmx, tmx))
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name,params", [
    ("normal", {"shape": (100_000,)}),
    ("normal", {"loc": 2.0, "scale": 0.5, "shape": (20, 30)}),
    ("_random_normal", {"mu": -1.0, "sigma": 3.0, "shape": (7, 9)}),
    ("_random_exponential", {"shape": (100_000,)}),
    ("_random_exponential", {"lam": 3.0, "shape": (40, 50)})])
def test_normal_and_exponential_are_bit_identical(name, params):
    """XLA's log1p and inverse error function, run op by op with its
    fused multiply-adds: the JAX package's draws bit for bit."""
    j, t = (_draw(mx, name, 12, **params) for mx in (jmx, tmx))
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_xla_log1p_and_erfinv_bit_for_bit():
    """The port's float32 log1p and inverse error function against
    jnp.log1p and lax.erf_inv over 10^6 seeded values, the edges and
    the special values included."""
    from mxnet_tpu_torch import random as trandom

    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-1, 1, 400_000),
                        rs.uniform(-1e-3, 1e-3, 100_000),
                        rs.uniform(0, 50, 100_000),
                        1 - rs.uniform(0, 1e-3, 400_000),
                        [0, -1, 1, 1e-30, np.inf, -2, np.nan]]).astype(
        np.float32)
    got = trandom._log1p32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.log1p(x)))
    u = x[np.abs(x) <= 1]
    got = trandom._erfinv32(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.lax.erf_inv(u)))


def test_the_key_chain_moves_with_every_random_op():
    """nd.Dropout draws no key in the port's kernel but advances the
    chain, as the JAX package's invoke does: the next uniform agrees."""
    outs = []
    for mx in (jmx, tmx):
        mx.random.seed(4)
        with mx.cpu():
            mx.nd.Dropout(mx.nd.ones((3,)), p=0.5)
            outs.append(mx.nd.uniform(shape=(8,)).asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])


# Two-sample Kolmogorov-Smirnov at 10^5 draws each: the p-value must stay
# above KS_P (the draws are seeded, so the statistic is fixed), and the
# means and variances agree to MOMENT_RTOL.
KS_DRAWS = 100_000
KS_P = 1e-3
MOMENT_RTOL = 0.03


@pytest.mark.parametrize("name,params", [
    ("_random_gamma", {"alpha": 2.5, "beta": 1.5}),
    ("_random_gamma", {"alpha": 0.4, "beta": 1.0}),
    ("_random_poisson", {"lam": 4.0}),
    ("_random_negative_binomial", {"k": 3.0, "p": 0.4}),
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5})])
def test_rejection_samplers_match_in_distribution(name, params):
    from scipy import stats

    j, t = (_draw(mx, name, 13, shape=(KS_DRAWS,), **params)
            for mx in (jmx, tmx))
    assert t.dtype == j.dtype == np.float32
    p = stats.ks_2samp(j, t).pvalue
    assert p > KS_P, (name, p)
    np.testing.assert_allclose(t.mean(), j.mean(), rtol=MOMENT_RTOL)
    np.testing.assert_allclose(t.var(), j.var(), rtol=MOMENT_RTOL)


# --------------------------------------------------------- symbolic path
@pytest.mark.parametrize("name", GRAD_OPS)
def test_symbol_infers_the_jax_packages_shapes(name):
    """mx.sym.<op> over Variables of the recipe's shapes: the port's
    infer_shape and infer_type (its ops run on meta tensors) give the
    JAX package's output shapes and types."""
    ins, params = LIBRARY_RECIPES[name](
        np.random.RandomState(abs(hash(name)) % 2**31))
    got = []
    for mx in (jmx, tmx):
        vs = [mx.sym.Variable(f"in{i}") for i in range(len(ins))]
        net = getattr(mx.sym, name)(*vs, **params)
        shapes = {f"in{i}": x.shape for i, x in enumerate(ins)}
        _, out_shapes, _ = net.infer_shape(**shapes)
        _, out_types, _ = net.infer_type(**{k: np.float32 for k in shapes})
        got.append((out_shapes, [np.dtype(t) for t in out_types]))
    assert got[1] == got[0], name
