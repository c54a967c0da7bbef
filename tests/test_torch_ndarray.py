"""The port's NDArray and imperative `nd` namespace against the JAX
package's, on the CPU.

- `mx.nd.<name>` for every op name (aliases included) the port
  registers: the same inputs, made from a numpy seed, through both
  packages' generated functions, within 1e-5 (absolute and relative),
  from a recipe table with one recipe per op. Each function takes its
  positional parameters in the JAX package's order.
- The NDArray methods and operators, against the JAX package's.
- `dir()` of the two NDArray classes: each reference name the port
  lacks would be listed in CLASS_MISSING with its ROADMAP.md item (none
  is). Every public name of the reference's `nd` namespace is bound in
  the port's, is refused with its ROADMAP.md item, or is one of the
  reference module's own imports.
- The reference's tests/test_ndarray.py, replayed on the port (its
  source with the package name replaced), for the tests that use only
  ported names; the others name the op that stops them.
"""
import inspect
import pathlib

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


def replay(test_file):
    """The namespace of a reference test file run against the port."""
    path = ROOT / "tests" / test_file
    src = path.read_text().replace("mxnet_tpu", "mxnet_tpu_torch")
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


def run_replayed(ns, name, tmp_path):
    fn = ns[name]
    params = inspect.signature(fn).parameters
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in params else {}
    with tmx.cpu():
        fn(**kwargs)


# ------------------------------------------------------------ recipes
def _randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _pos(rs, *shape):
    return rs.uniform(0.5, 2.0, shape).astype(np.float32)


def _ints(rs, *shape):
    return rs.randint(0, 3, shape).astype(np.float32)


def _unary(rs):
    return [_randn(rs, 3, 4)], {}


def _unary_pos(rs):
    return [_pos(rs, 3, 4)], {}


def _binary(rs):
    return [_randn(rs, 3, 4), _randn(rs, 3, 4)], {}


def _scalar(rs):
    return [_randn(rs, 3, 4)], {"scalar": 0.75}


def _scalar_pos(rs):
    return [_pos(rs, 3, 4)], {"scalar": 1.5}


def _logic(rs):
    return [_ints(rs, 4, 5), _ints(rs, 4, 5)], {}


def _scalar_logic(rs):
    return [_ints(rs, 4, 5)], {"scalar": 1.0}


def _reduce(rs):
    return [_randn(rs, 3, 4, 5)], {"axis": 1, "keepdims": True}


def _conv(rs):
    return ([_randn(rs, 2, 3, 6, 6), _randn(rs, 4, 3, 3, 3) * 0.2,
             _randn(rs, 4)],
            {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)})


def _batchnorm(rs):
    return ([_randn(rs, 2, 3, 4, 4), _pos(rs, 3), _randn(rs, 3),
             _randn(rs, 3), _pos(rs, 3)], {"fix_gamma": False})


def _update(n_state):
    def recipe(rs):
        return ([_randn(rs, 3, 4), _randn(rs, 3, 4)]
                + [_pos(rs, 3, 4) * 0.1 for _ in range(n_state)],
                {"lr": 0.05, "wd": 0.01, "rescale_grad": 0.5})
    return recipe


def _head(rs):
    return [_randn(rs, 4, 5), _randn(rs, 4, 5)], {}


RECIPES = {
    "relu": _unary, "sigmoid": _unary, "tanh": _unary, "exp": _unary,
    "log": _unary_pos, "log1p": _unary_pos, "expm1": _unary,
    "sqrt": _unary_pos, "rsqrt": _unary_pos, "square": _unary,
    "abs": _unary, "sign": _unary, "negative": _unary,
    "reciprocal": _unary_pos, "softsign": _unary, "erf": _unary,
    "_copy": _unary, "identity": _unary,
    "cast": lambda rs: ([_randn(rs, 3, 4)], {"dtype": "float16"}),
    "elemwise_add": _binary, "elemwise_sub": _binary,
    "elemwise_mul": _binary, "elemwise_div":
        lambda rs: ([_randn(rs, 3, 4), _pos(rs, 3, 4)], {}),
    "_power": lambda rs: ([_pos(rs, 3, 4), _randn(rs, 3, 4)], {}),
    "_maximum": _binary, "_minimum": _binary,
    "_mod": lambda rs: ([_randn(rs, 3, 4) * 3, _pos(rs, 3, 4)], {}),
    "broadcast_add": lambda rs: ([_randn(rs, 3, 4), _randn(rs, 1, 4)], {}),
    "broadcast_sub": lambda rs: ([_randn(rs, 3, 4), _randn(rs, 3, 1)], {}),
    "broadcast_mul": lambda rs: ([_randn(rs, 3, 4), _randn(rs, 1, 4)], {}),
    "broadcast_div": lambda rs: ([_randn(rs, 3, 4), _pos(rs, 3, 1)], {}),
    "broadcast_power": lambda rs: ([_pos(rs, 3, 4), _randn(rs, 1, 4)], {}),
    "broadcast_maximum": lambda rs: ([_randn(rs, 3, 4), _randn(rs, 1, 4)],
                                     {}),
    "broadcast_minimum": lambda rs: ([_randn(rs, 3, 4), _randn(rs, 3, 1)],
                                     {}),
    "_equal": _logic, "_not_equal": _logic, "_greater": _logic,
    "_greater_equal": _logic, "_lesser": _logic, "_lesser_equal": _logic,
    "_plus_scalar": _scalar, "_minus_scalar": _scalar,
    "_rminus_scalar": _scalar, "_mul_scalar": _scalar,
    "_div_scalar": _scalar, "_rdiv_scalar": _scalar_pos,
    "_power_scalar": _scalar_pos, "_rpower_scalar": _scalar,
    "_maximum_scalar": _scalar, "_minimum_scalar": _scalar,
    "_mod_scalar": lambda rs: ([_randn(rs, 3, 4) * 3], {"scalar": 1.25}),
    "_rmod_scalar": lambda rs: ([_pos(rs, 3, 4)], {"scalar": 2.5}),
    "_equal_scalar": _scalar_logic, "_not_equal_scalar": _scalar_logic,
    "_greater_scalar": _scalar_logic,
    "_greater_equal_scalar": _scalar_logic,
    "_lesser_scalar": _scalar_logic, "_lesser_equal_scalar": _scalar_logic,
    "smooth_l1": lambda rs: ([_randn(rs, 3, 4)], {"scalar": 1.5}),
    "sum": _reduce, "mean": _reduce, "max": _reduce, "min": _reduce,
    "reshape": lambda rs: ([_randn(rs, 2, 3, 4)], {"shape": (0, -1)}),
    "flatten": lambda rs: ([_randn(rs, 2, 3, 4)], {}),
    "clip": lambda rs: ([_randn(rs, 3, 4)], {"a_min": -0.5, "a_max": 0.7}),
    "Concat": lambda rs: ([_randn(rs, 2, 3), _randn(rs, 2, 4)], {"dim": 1}),
    "SliceChannel": lambda rs: ([_randn(rs, 2, 6)], {"num_outputs": 3}),
    "dot": lambda rs: ([_randn(rs, 3, 4), _randn(rs, 5, 4)],
                       {"transpose_b": True}),
    "transpose": lambda rs: ([_randn(rs, 2, 3, 4)], {"axes": (1, 0, 2)}),
    "expand_dims": lambda rs: ([_randn(rs, 3, 4)], {"axis": 1}),
    "_zeros": lambda rs: ([], {"shape": (2, 3)}),
    "_ones": lambda rs: ([], {"shape": (2, 3)}),
    "_graph_constant": lambda rs: ([], {"value": ((1.0, 2.0), (3.0, 4.0))}),
    "pick": lambda rs: ([_randn(rs, 4, 5), rs.randint(0, 5, 4).astype(
        np.float32)], {"axis": 1}),
    "Activation": lambda rs: ([_randn(rs, 3, 4)], {"act_type": "tanh"}),
    "LeakyReLU": lambda rs: ([_randn(rs, 3, 4)], {"act_type": "leaky",
                                                  "slope": 0.1}),
    "FullyConnected": lambda rs: ([_randn(rs, 4, 6), _randn(rs, 5, 6),
                                   _randn(rs, 5)], {"num_hidden": 5}),
    "Convolution": _conv,
    "Pooling": lambda rs: ([_randn(rs, 2, 3, 6, 6)],
                           {"kernel": (2, 2), "stride": (2, 2),
                            "pool_type": "avg"}),
    "BatchNorm": _batchnorm,
    "softmax": lambda rs: ([_randn(rs, 4, 5)], {"axis": -1,
                                                "temperature": 2.0}),
    "log_softmax": lambda rs: ([_randn(rs, 4, 5)], {"axis": 0}),
    "Dropout": lambda rs: ([_randn(rs, 3, 4)], {"p": 0.3}),
    "SoftmaxOutput": lambda rs: ([_randn(rs, 4, 5), rs.randint(
        0, 5, 4).astype(np.float32)], {}),
    "LinearRegressionOutput": _head, "MAERegressionOutput": _head,
    "LogisticRegressionOutput": _head,
    "MakeLoss": lambda rs: ([_randn(rs, 3, 4)], {"grad_scale": 2.0}),
    "sgd_update": _update(0), "sgd_mom_update":
        lambda rs: _update(1)(rs)[0:1] + ({"lr": 0.05, "momentum": 0.9,
                                           "wd": 0.01},),
    "adam_update": _update(2), "rmsprop_update": _update(1),
    "rmspropalex_update": _update(3),
    "RingAttention": lambda rs: ([_randn(rs, 1, 6, 2, 4) for _ in range(3)],
                                 {"causal": True}),
    # 12 tokens, 3 experts of capacity 3: some are dropped
    "MoEFFN": lambda rs: ([_randn(rs, 2, 6, 4), _randn(rs, 4, 3),
                          _randn(rs, 3, 4, 8), _randn(rs, 3, 8, 4)],
                         {"num_experts": 3, "hidden_size": 8,
                          "capacity_factor": 0.75}),
}


# ------------------------------------------- the rest of the op library
def _away(rs, *shape):
    """Magnitudes in [0.3, 1.5) with random signs: away from 0 (cbrt's
    gradient) and from the integers' halves (round's)."""
    return (rs.uniform(0.3, 1.5, shape) * rs.choice([-1, 1], shape)).astype(
        np.float32)


def _unit(rs):
    return [rs.uniform(-0.8, 0.8, (3, 4)).astype(np.float32)], {}


def _ties(rs, *shape):
    return rs.randint(0, 4, shape).astype(np.float32)


def _seq(rs):
    return [_randn(rs, 5, 3, 4), np.array([3, 5, 2], np.float32)], \
        {"use_sequence_length": True}


def _rnn(mode, bidirectional=False, layers=2, state_outputs=True,
         batch_one_state=False):
    def recipe(rs):
        from mxnet_tpu_torch.ops.rnn_op import rnn_param_size

        t, n, i, h = 4, 3, 5, 6
        dirs = 2 if bidirectional else 1
        size = rnn_param_size(i, h, layers, bidirectional, mode)
        sn = 1 if batch_one_state else n
        ins = [_randn(rs, t, n, i), _randn(rs, size) * 0.3,
               _randn(rs, layers * dirs, sn, h) * 0.5]
        if mode == "lstm":
            ins.append(_randn(rs, layers * dirs, sn, h) * 0.5)
        return ins, {"state_size": h, "num_layers": layers, "mode": mode,
                     "bidirectional": bidirectional,
                     "state_outputs": state_outputs}
    return recipe


def _ctc(blank_label="first", lengths=False):
    def recipe(rs):
        t, n, c = 6, 3, 5
        pad = 0 if blank_label == "first" else -1
        lab = np.array([[1, 2, 2, pad], [3, pad, pad, pad], [1, 3, 1, 2]],
                       np.float32)
        params = {"blank_label": blank_label}
        ins = [_randn(rs, t, n, c), lab]
        if lengths:
            ins += [np.array([6, 4, 5], np.float32),
                    np.array([3, 1, 3], np.float32)]
            params.update(use_data_lengths=True, use_label_lengths=True)
        return ins, params
    return recipe


LIBRARY_RECIPES = {
    "log2": _unary_pos, "log10": _unary_pos,
    "cbrt": lambda rs: ([_away(rs, 3, 4)], {}),
    "rcbrt": lambda rs: ([_away(rs, 3, 4)], {}),
    "round": lambda rs: ([_away(rs, 3, 4) * 3], {}),
    "rint": lambda rs: ([_away(rs, 3, 4) * 3], {}),
    "ceil": lambda rs: ([_away(rs, 3, 4) * 3], {}),
    "floor": lambda rs: ([_away(rs, 3, 4) * 3], {}),
    "fix": lambda rs: ([_away(rs, 3, 4) * 3], {}),
    "trunc": lambda rs: ([_away(rs, 3, 4) * 3], {}),
    "gamma": lambda rs: ([rs.uniform(0.3, 3.0, (3, 4)).astype(np.float32)],
                         {}),
    "gammaln": _unary_pos, "degrees": _unary, "radians": _unary,
    "sin": _unary, "cos": _unary, "tan": _unit, "arcsin": _unit,
    "arccos": _unit, "arctan": _unary, "sinh": _unary, "cosh": _unary,
    "arcsinh": _unary, "arctanh": _unit, "erfinv": _unit,
    "arccosh": lambda rs: ([rs.uniform(1.2, 3.0, (3, 4)).astype(
        np.float32)], {}),
    "logical_not": lambda rs: ([_ties(rs, 3, 4)], {}),
    "_identity_with_attr_like_rhs": _binary,
    "BlockGrad": _unary,
    "_hypot": _binary,
    "_hypot_scalar": _scalar,
    "add_n": lambda rs: ([_randn(rs, 3, 4) for _ in range(3)], {}),
    "broadcast_mod": lambda rs: ([_randn(rs, 3, 4) * 3, _pos(rs, 1, 4)], {}),
    "broadcast_hypot": lambda rs: ([_randn(rs, 3, 4), _randn(rs, 3, 1)], {}),
    "broadcast_equal": lambda rs: ([_ties(rs, 4, 5), _ties(rs, 1, 5)], {}),
    "broadcast_not_equal": lambda rs: ([_ties(rs, 4, 5), _ties(rs, 4, 1)],
                                       {}),
    "broadcast_greater": lambda rs: ([_ties(rs, 4, 5), _ties(rs, 1, 5)], {}),
    "broadcast_greater_equal": lambda rs: ([_ties(rs, 4, 5),
                                            _ties(rs, 1, 5)], {}),
    "broadcast_lesser": lambda rs: ([_ties(rs, 4, 5), _ties(rs, 4, 1)], {}),
    "broadcast_lesser_equal": lambda rs: ([_ties(rs, 4, 5),
                                           _ties(rs, 1, 5)], {}),
    "prod": lambda rs: ([_away(rs, 3, 4, 5)], {"axis": (0, 2)}),
    "nansum": lambda rs: ([np.where(rs.rand(3, 4, 5) < 0.2, np.nan,
                                    _randn(rs, 3, 4, 5)).astype(
                                        np.float32)], {"axis": 1}),
    "nanprod": lambda rs: ([np.where(rs.rand(3, 4, 5) < 0.2, np.nan,
                                     _away(rs, 3, 4, 5)).astype(
                                         np.float32)], {"axis": 2,
                                                        "keepdims": True}),
    "norm": _unary,
    "argmax": lambda rs: ([_ties(rs, 4, 5)], {"axis": 1}),
    "argmin": lambda rs: ([_ties(rs, 4, 5)], {"axis": 0, "keepdims": True}),
    "argmax_channel": lambda rs: ([_ties(rs, 4, 5)], {}),
    "broadcast_to": lambda rs: ([_randn(rs, 3, 1)], {"shape": (0, 4)}),
    "broadcast_axis": lambda rs: ([_randn(rs, 1, 3, 1)],
                                  {"axis": (0, 2), "size": (2, 4)}),
    "SwapAxis": lambda rs: ([_randn(rs, 2, 3, 4)], {"dim1": 0, "dim2": 2}),
    "batch_dot": lambda rs: ([_randn(rs, 2, 4, 3), _randn(rs, 2, 5, 4)],
                             {"transpose_a": True, "transpose_b": True}),
    "slice": lambda rs: ([_randn(rs, 4, 5, 3)],
                         {"begin": (1, None), "end": (3, -1)}),
    "slice_axis": lambda rs: ([_randn(rs, 4, 5)],
                              {"axis": 1, "begin": 1, "end": None}),
    "flip": lambda rs: ([_randn(rs, 3, 4, 2)], {"axis": (0, 2)}),
    "repeat": lambda rs: ([_randn(rs, 3, 4)], {"repeats": 2}),
    "tile": lambda rs: ([_randn(rs, 3, 4)], {"reps": (2, 1, 3)}),
    "stack": lambda rs: ([_randn(rs, 3, 4), _randn(rs, 3, 4)], {"axis": 1}),
    "Pad": lambda rs: ([_randn(rs, 2, 3, 4, 5)],
                       {"mode": "reflect",
                        "pad_width": (0, 0, 0, 0, 2, 3, 1, 4)}),
    "Crop": lambda rs: ([_randn(rs, 2, 3, 6, 7), _randn(rs, 2, 3, 3, 4)],
                        {"center_crop": True}),
    "Embedding": lambda rs: ([np.array([[0, 4, -1], [1.7, 5, -6]],
                                       np.float32), _randn(rs, 5, 3)],
                             {"input_dim": 5, "output_dim": 3}),
    "take": lambda rs: ([_randn(rs, 4, 5), np.array([[0, 6], [-2, 3]],
                                                    np.float32)],
                        {"axis": 1, "mode": "wrap"}),
    "batch_take": lambda rs: ([_randn(rs, 3, 5), np.array([4, 0, -1],
                                                          np.float32)], {}),
    "one_hot": lambda rs: ([np.array([0, 3, 1, 5], np.float32)],
                           {"depth": 4, "on_value": 2.0,
                            "off_value": -1.0}),
    "where": lambda rs: ([np.array([1, 0, 1], np.float32), _randn(rs, 3, 4),
                          _randn(rs, 3, 4)], {}),
    "sort": lambda rs: ([_ties(rs, 4, 6)], {"axis": 1, "is_ascend": False}),
    "argsort": lambda rs: ([_ties(rs, 4, 6)], {"axis": 0,
                                               "is_ascend": False}),
    "topk": lambda rs: ([_ties(rs, 4, 6)], {"axis": 1, "k": 3,
                                            "ret_typ": "both"}),
    "_arange": lambda rs: ([], {"start": 1.0, "stop": 7.0, "step": 1.5,
                                "repeat": 2}),
    "_full": lambda rs: ([], {"shape": (2, 3), "value": 2.5}),
    "ones_like": _unary, "zeros_like": _unary,
    "_random_uniform": lambda rs: ([], {"low": -2.0, "high": 3.0,
                                        "shape": (4, 5)}),
    "_random_normal": lambda rs: ([], {"loc": 1.0, "scale": 2.0,
                                       "shape": (4, 5)}),
    "_random_exponential": lambda rs: ([], {"lam": 2.0, "shape": (4, 5)}),
    "Deconvolution": lambda rs: ([_randn(rs, 2, 3, 5, 5),
                                  _randn(rs, 3, 4, 3, 3) * 0.3,
                                  _randn(rs, 4)],
                                 {"kernel": (3, 3), "num_filter": 4,
                                  "stride": (2, 2), "pad": (1, 1),
                                  "adj": (1, 1), "no_bias": False}),
    "SoftmaxActivation": lambda rs: ([_randn(rs, 2, 3, 4)],
                                     {"mode": "channel"}),
    "SVMOutput": lambda rs: ([_randn(rs, 4, 5), rs.randint(0, 5, 4).astype(
        np.float32)], {"margin": 0.5, "use_linear": False}),
    "LRN": lambda rs: ([_randn(rs, 2, 6, 3, 3)], {"nsize": 3, "alpha": 0.1}),
    "InstanceNorm": lambda rs: ([_randn(rs, 2, 3, 4, 4), _pos(rs, 3),
                                 _randn(rs, 3)], {"eps": 1e-3}),
    "L2Normalization": lambda rs: ([_randn(rs, 2, 3, 4)],
                                   {"mode": "spatial"}),
    "UpSampling": lambda rs: ([_randn(rs, 2, 3, 4, 4), _randn(rs, 2, 2, 2, 2)],
                              {"scale": 2, "sample_type": "nearest",
                               "num_args": 2}),
    "SequenceLast": _seq, "SequenceMask": lambda rs: (
        _seq(rs)[0], {"use_sequence_length": True, "value": -1.0}),
    "SequenceReverse": _seq,
    "IdentityAttachKLSparseReg": _unary,
    "softmax_cross_entropy": lambda rs: ([_randn(rs, 4, 5), rs.randint(
        0, 5, 4).astype(np.float32)], {}),
    "CTCLoss": _ctc("first"),
    "RNN": _rnn("lstm"),
}
RECIPES.update(LIBRARY_RECIPES)


# ------------------------------------------------------- vision recipes
def _identity_theta(rs, n):
    return (np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (n, 1))
            + rs.uniform(-0.3, 0.3, (n, 6)).astype(np.float32))


def _anchors(rs, a):
    """(1, a, 4) corner boxes in [0, 1]."""
    c = rs.uniform(0.1, 0.9, (a, 2))
    wh = rs.uniform(0.05, 0.5, (a, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1)[None].astype(
        np.float32)


def _gt_labels(rs, b, g, num_cls):
    """(b, g, 5) [cls, corners] with the last row of each image
    padding (class -1)."""
    lab = np.full((b, g, 5), -1.0, np.float32)
    boxes = _anchors(rs, b * (g - 1))[0].reshape(b, g - 1, 4)
    lab[:, :g - 1, 1:] = boxes
    lab[:, :g - 1, 0] = rs.randint(0, num_cls, (b, g - 1))
    return lab


def _softmax_rows(x, axis):
    e = np.exp(x - x.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


VISION_RECIPES = {
    "GridGenerator": lambda rs: ([_identity_theta(rs, 2)],
                                 {"transform_type": "affine",
                                  "target_shape": (4, 5)}),
    "BilinearSampler": lambda rs: ([_randn(rs, 2, 3, 5, 6), rs.uniform(
        -1.2, 1.2, (2, 2, 4, 5)).astype(np.float32)], {}),
    "SpatialTransformer": lambda rs: ([_randn(rs, 2, 3, 5, 6),
                                       _identity_theta(rs, 2)],
                                      {"target_shape": (4, 5)}),
    "ROIPooling": lambda rs: ([_randn(rs, 2, 3, 8, 9), np.array(
        [[0, 1, 2, 13, 11], [1, 0, 0, 17, 15], [1, 5.5, 3, 9, 12.7],
         [0, 15, 12, 30, 30]], np.float32)],
        {"pooled_size": (2, 3), "spatial_scale": 0.5}),
    "Correlation": lambda rs: ([_randn(rs, 1, 3, 5, 6),
                                _randn(rs, 1, 3, 5, 6)],
                               {"max_displacement": 2, "stride2": 2}),
    "MultiBoxPrior": lambda rs: ([_randn(rs, 1, 3, 4, 5)],
                                 {"sizes": (0.5, 0.25),
                                  "ratios": (1.0, 2.0, 0.5), "clip": True}),
    "MultiBoxTarget": lambda rs: ([_anchors(rs, 40), _gt_labels(rs, 2, 4, 2),
                                   _randn(rs, 2, 3, 40)],
                                  {"negative_mining_ratio": 3.0,
                                   "overlap_threshold": 0.4}),
    "MultiBoxDetection": lambda rs: ([_softmax_rows(_randn(rs, 2, 3, 40), 1),
                                      _randn(rs, 2, 160) * 0.5,
                                      _anchors(rs, 40)],
                                     {"threshold": 0.3,
                                      "nms_threshold": 0.3}),
    "Proposal": lambda rs: ([rs.rand(1, 6, 4, 4).astype(np.float32),
                             (_randn(rs, 1, 12, 4, 4) * 0.1),
                             np.array([[64, 64, 1.0]], np.float32)],
                            {"feature_stride": 16, "scales": (2.0,),
                             "ratios": (0.5, 1.0, 2.0),
                             "rpn_pre_nms_top_n": 30,
                             "rpn_post_nms_top_n": 8, "rpn_min_size": 4,
                             "threshold": 0.5}),
    "fft": lambda rs: ([_randn(rs, 3, 8)], {}),
    "ifft": lambda rs: ([_randn(rs, 3, 16)], {}),
    "count_sketch": lambda rs: ([_randn(rs, 3, 6), rs.randint(
        0, 4, (1, 6)).astype(np.float32), np.sign(_randn(rs, 1, 6))],
        {"out_dim": 4}),
    "quantize": lambda rs: ([rs.uniform(-1, 1, (3, 4)).astype(np.float32),
                             np.array([-0.8], np.float32),
                             np.array([0.9], np.float32)], {}),
    "dequantize": lambda rs: ([rs.randint(0, 256, (3, 4)).astype(
        np.float32), np.array([-0.8], np.float32),
        np.array([0.9], np.float32)], {}),
}
RECIPES.update(VISION_RECIPES)
# held elsewhere
NOT_COMPARED = {"Custom": "tests/test_torch_custom_op.py holds Custom "
                          "through both packages"}
# draws that repeat jax.random's in distribution, not value by value
NOT_COMPARED.update({
    op: "tests/test_torch_ops_library.py holds its draws to the JAX "
        "package's by a two-sample KS test"
    for op in ("_random_gamma", "_random_poisson",
               "_random_negative_binomial",
               "_random_generalized_negative_binomial")})


def _canonical(name):
    return treg.get(name).name


@pytest.mark.parametrize("name", treg.list_ops())
def test_nd_function_matches_jax(name):
    """nd.<name> on the same seeded inputs in both packages."""
    op = _canonical(name)
    if op in NOT_COMPARED:
        assert op in jreg.list_ops()
        return
    rs = np.random.RandomState(abs(hash(op)) % 2**31)
    inputs, params = RECIPES[op](rs)
    outs = []
    for mx in (jmx, tmx):
        mx.random.seed(3)       # the samplers draw from the key chain
        with mx.cpu():
            args = [mx.nd.array(x, ctx=mx.cpu()) for x in inputs]
            res = getattr(mx.nd, name)(*args, **params)
        res = res if isinstance(res, list) else [res]
        outs.append([r.asnumpy().astype(np.float64) for r in res])
    assert len(outs[0]) == len(outs[1])
    for j, t in zip(*outs):
        assert j.shape == t.shape, name
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL, err_msg=name)


def test_every_port_op_has_a_recipe_and_a_reference():
    ops = {_canonical(n) for n in treg.list_ops()}
    assert ops <= set(RECIPES) | set(NOT_COMPARED)
    assert set(treg.list_ops()) <= set(jreg.list_ops())


@pytest.mark.parametrize("name", treg.list_ops())
def test_positional_params_in_the_reference_order(name):
    """nd.clip(x, -1, 1)-style calls map their positional parameters as
    in the JAX package."""
    import mxnet_tpu.ndarray as jnd
    import mxnet_tpu_torch.ndarray as tnd

    assert tnd._op_param_order(treg.get(name)) == \
        jnd._op_param_order(jreg.get(name))


def test_positional_params_call():
    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    got = [mx.nd.clip(mx.nd.array(x, ctx=mx.cpu()), -1.0, 1.5).asnumpy()
           for mx in (jmx, tmx)]
    np.testing.assert_array_equal(got[0], got[1])


def test_reference_op_list_is_the_jax_packages():
    """The port's op names and the names it refuses (registry.NOT_PORTED)
    are the JAX package's registry."""
    assert set(treg.list_ops()) | set(treg.NOT_PORTED) == \
        set(jreg.list_ops())
    assert not set(treg.list_ops()) & set(treg.NOT_PORTED)


# ------------------------------------------------ methods and operators
def _pair(x):
    return (jmx.nd.array(x, ctx=jmx.cpu()), tmx.nd.array(x, ctx=tmx.cpu()))


METHODS = {
    "reshape": lambda a: a.reshape((4, 3)),
    "reshape_int": lambda a: a.reshape(12),
    "T": lambda a: a.T,
    "broadcast_to": lambda a: a[0:1].broadcast_to((5, 4)),
    "astype": lambda a: a.astype(np.float16),
    "copy": lambda a: a.copy(),
    "as_in_context": lambda a: a.as_in_context(a.context),
    "getitem_int": lambda a: a[1],
    "getitem_slice": lambda a: a[1:3],
    "getitem_step": lambda a: a[::2],
    "getitem_tuple": lambda a: a[1:3, 2],
    "pow": lambda a: a ** 2,
    "pow_array": lambda a: abs(a) ** a,
    "rpow": lambda a: 2.0 ** a,
    "mod": lambda a: a % 0.75,
    "mod_array": lambda a: a % (abs(a) + 0.5),
    "rmod": lambda a: 3.0 % (abs(a) + 0.5),
    "neg": lambda a: -a,
    "abs": lambda a: abs(a),
    "add": lambda a: a + a * 2,
    "radd": lambda a: 1.5 + a,
    "sub": lambda a: a - 3,
    "rsub": lambda a: 3 - a,
    "mul": lambda a: 3 * a,
    "div": lambda a: a / 4,
    "rdiv": lambda a: 1.0 / (abs(a) + 1),
    "eq": lambda a: (a * 0 + 1) == (abs(a) > 0.5),
    "ne": lambda a: a != 0.25,
    "gt": lambda a: a > 0.1,
    "ge": lambda a: a >= a.T.T,
    "lt": lambda a: a < 0,
    "le": lambda a: a <= 0.3,
    "maximum": lambda a: (a, 0.2),
    "minimum": lambda a: (a, a * 0.5),
    "transpose_fn": lambda a: (a,),
    "moveaxis": lambda a: (a.reshape((2, 3, 2)), 0, 2),
    "concatenate": lambda a: ([a, a * 2],),
    "true_divide": lambda a: (a, 3.0),
    "negative": lambda a: (a,),
    "modulo": lambda a: (a, 0.6),
    "power": lambda a: (abs(a), 2.0),
    "zeros_like": lambda a: (a,),
    "ones_like": lambda a: (a,),
}
FUNCS = {"maximum": "maximum", "minimum": "minimum",
         "transpose_fn": "transpose", "moveaxis": "moveaxis",
         "concatenate": "concatenate", "true_divide": "true_divide",
         "negative": "negative", "modulo": "modulo", "power": "power",
         "zeros_like": "zeros_like", "ones_like": "ones_like"}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_method_matches_jax(name):
    x = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    outs = []
    for mx, a in zip((jmx, tmx), _pair(x)):
        res = METHODS[name](a)
        if name in FUNCS:
            res = getattr(mx.nd, FUNCS[name])(*res)
        outs.append(res)
    j, t = outs
    assert j.shape == t.shape
    assert np.dtype(j.dtype) == np.dtype(t.dtype)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=TOL, atol=TOL)


def test_creators_match_jax():
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            got.append([a.asnumpy() for a in (
                mx.nd.full((2, 3), 2.5), mx.nd.ones((2, 2)),
                mx.nd.arange(1, 7, 1.5, repeat=2),
                mx.nd.arange(5, dtype=np.int32))])
    for j, t in zip(*got):
        assert j.dtype == t.dtype
        np.testing.assert_array_equal(t, j)


def test_scalar_sync_and_writable():
    j, t = _pair(np.array([[2.5]], np.float32))
    assert t.asscalar() == j.asscalar() == np.float32(2.5)
    assert float(t) == 2.5 and int(t) == 2
    t.wait_to_read()
    t.wait_to_write()
    assert t.writable
    step = t.reshape((1,))[::1]
    assert step.writable
    with pytest.raises(tmx.MXNetError):
        tmx.nd.array(np.zeros(4, np.float32), ctx=tmx.cpu())[::2][:] = 1.0
    with pytest.raises(tmx.MXNetError):
        tmx.nd.zeros((2, 2), ctx=tmx.cpu()).asscalar()


def test_inplace_and_views_write_through():
    """In place outside recording: views see the write, an op's out=
    writes into the given array's storage."""
    a = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                     ctx=tmx.cpu())
    storage = a.data.data_ptr()
    row = a[1]
    a += 1
    a *= 2
    row[:] = -1
    tmx.nd.elemwise_add(a, a, out=a)
    assert a.data.data_ptr() == storage
    np.testing.assert_array_equal(a.asnumpy(), [[4, 8, 12], [-2, -2, -2]])


def test_pickle_roundtrip():
    import pickle

    t = tmx.nd.array(np.arange(4, dtype=np.float32), ctx=tmx.cpu())
    back = pickle.loads(pickle.dumps(t))
    np.testing.assert_array_equal(back.asnumpy(), t.asnumpy())
    assert back.context == t.context


def test_array_follows_the_current_context():
    """No ctx: the current context, which is the card by default (so on
    this host, with no card, a creator refuses rather than run on the
    host); a scope or ctx= names the host."""
    if not tmx.context.torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            tmx.nd.array(np.zeros(2))
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            tmx.nd.zeros((2,))
    with tmx.cpu():
        assert tmx.nd.array(np.zeros(2)).context == tmx.cpu()
        assert tmx.nd.ones((2,)).context == tmx.cpu()


# ------------------------------------------------------------ dir()
# reference NDArray names the port does not have -> ROADMAP.md item
CLASS_MISSING = {}
# public names of mxnet_tpu/ndarray.py that are its own imports or
# helpers of its JAX storage, not part of the nd API
MODULE_OWN = {"jax", "jnp", "np", "struct", "sys", "Chunk",
              "ones_like_nd", "tpu", "gpu", "cpu", "default_context"}


def _public(names):
    return {n for n in names if not n.startswith("_")}


def test_ndarray_class_dir_matches_the_reference():
    ref = set(dir(jmx.nd.NDArray)) - {"_chunk", "_base", "_index"}
    port = set(dir(tmx.nd.NDArray))
    missing = sorted(ref - port)
    assert missing == sorted(CLASS_MISSING), missing


def test_nd_namespace_covers_the_reference():
    """Each public name of the reference's nd namespace: bound in the
    port, refused with its ROADMAP.md item, or the reference module's
    own import."""
    unbound = {}
    for name in sorted(_public(dir(jmx.nd)) - MODULE_OWN):
        try:
            getattr(tmx.nd, name)
        except treg.NotPortedError as e:
            unbound[name] = str(e)
    for name, msg in unbound.items():
        assert "ROADMAP.md A." in msg, (name, msg)
        assert not hasattr(tmx.nd, name)
    # nd.imdecode decodes as the JAX package's does (a PNG: lossless,
    # so the pixels are the seeded ones)
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    from mxnet_tpu import recordio as jrecordio

    buf = jrecordio._imencode_np(img, img_fmt=".png")
    got = tmx.nd.imdecode(buf)
    want = jmx.nd.imdecode(buf).asnumpy()
    assert got.dtype == np.uint8 and got.context == tmx.cpu()
    np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(want, img[:, :, ::-1])
    assert treg.NOT_PORTED == {} and unbound == {}
    assert callable(tmx.nd.MoEFFN) and callable(tmx.nd.moe_ffn)
    bound = _public(dir(jmx.nd)) - MODULE_OWN - set(unbound)
    assert all(hasattr(tmx.nd, n) for n in bound)


def test_unported_op_refused_with_its_item():
    """No op name of the JAX package is refused now: the mixture of
    experts, the last one queued (ROADMAP.md A.9), is bound in nd and
    sym; a name neither package has is still an AttributeError."""
    assert treg.NOT_PORTED == {}
    assert callable(tmx.nd.MoEFFN) and callable(tmx.sym.moe_ffn)
    assert callable(tmx.nd.ROIPooling) and callable(tmx.sym.MultiBoxPrior)
    with pytest.raises(AttributeError):
        tmx.nd.no_such_name


# -------------------------------------------------- reference replay
REPLAYED = ["test_creation", "test_elementwise", "test_inplace",
            "test_comparison", "test_views_write_through", "test_setitem",
            "test_dot", "test_concat_split", "test_save_load",
            "test_copyto_astype_context", "test_out_kwarg",
            "test_reductions", "test_reshape_slice", "test_broadcast",
            "test_take_onehot_pick", "test_topk_sort",
            "test_random_reproducible"]
# reference tests that need ops the port does not register yet
NOT_REPLAYED = {}


@pytest.fixture(scope="module")
def reference_ndarray_tests():
    return replay("test_ndarray.py")


@pytest.mark.parametrize("name", REPLAYED)
def test_reference_ndarray_test_on_the_port(name, reference_ndarray_tests,
                                            tmp_path):
    run_replayed(reference_ndarray_tests, name, tmp_path)


def test_replay_covers_the_reference_file(reference_ndarray_tests):
    names = {n for n in reference_ndarray_tests if n.startswith("test_")}
    assert names == set(REPLAYED) | set(NOT_REPLAYED)
    for name, op in NOT_REPLAYED.items():
        with pytest.raises(treg.NotPortedError, match="ROADMAP.md A."):
            run_replayed(reference_ndarray_tests, name, None)
        assert op in treg.NOT_PORTED
