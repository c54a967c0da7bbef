"""Python-defined operators in the port (operator.py, the Custom op)
against the JAX package's, on the CPU.

The four tests of tests/test_custom_op.py (a softmax-CE loss head as a
CustomOp with need_top_grad=False, alone and behind a FullyConnected, a
NumpyOp and an NDArrayOp) run in both packages: outputs and input
gradients agree within 1e-6 (float32 arithmetic of the same numpy or
NDArray bodies; the FullyConnected layer sums in another order). An op
with two outputs and need_top_grad=True records the arguments its
forward and backward receive, which must be the JAX package's, head
gradients included (the JAX package calls both twice when it is given
head gradients, the port once). examples/numpy_ops/custom_softmax.py's
net takes 20 SGD steps in both packages from the same initial weights and batches:
parameters agree within 1e-5. Plus the registry (re-registration clears
the prop cache), the shape rule (a label shape inferred from the data),
the aux-state refusal, `assign`'s reqs and the graph JSON.
"""
import importlib.util
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
STEP_TOL = 1e-5


def _register_softmax(mx, op_type):
    op = mx.operator

    class _Softmax(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy()
            y[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @op.register(op_type)
    class _SoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return _Softmax()


for _mx in (jmx, tmx):
    _register_softmax(_mx, "parity_softmax")


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_softmax_head_against_numpy(mx):
    """tests/test_custom_op.py::test_custom_op_forward_backward."""
    sym = mx.sym.Custom(data=mx.sym.Variable("data"),
                        label=mx.sym.Variable("label"),
                        op_type="parity_softmax", name="softmax")
    ex = sym.simple_bind(ctx=mx.cpu(), data=(4, 5), label=(4,),
                         grad_req="write")
    x = np.random.RandomState(0).rand(4, 5).astype(np.float32)
    label = np.array([0, 1, 2, 3], np.float32)
    out = ex.forward(is_train=True, data=x, label=label)[0].asnumpy()
    ref = np.exp(x - x.max(1, keepdims=True))
    ref /= ref.sum(1, keepdims=True)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    ex.backward()
    expect = ref.copy()
    expect[np.arange(4), label.astype(int)] -= 1
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(), expect,
                               rtol=1e-5)
    # the label's gradient is the zeroed in_grad the op left alone
    np.testing.assert_array_equal(ex.grad_dict["label"].asnumpy(),
                                  np.zeros(4, np.float32))


def _larger_graph(mx):
    """tests/test_custom_op.py::test_custom_op_in_larger_graph."""
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=5, name="fc")
    sm = mx.sym.Custom(data=fc, label=mx.sym.Variable("label"),
                       op_type="parity_softmax", name="softmax")
    ex = sm.simple_bind(ctx=mx.cpu(), data=(4, 3), label=(4,),
                        grad_req="write")
    rs = np.random.RandomState(1)
    ex.arg_dict["fc_weight"][:] = rs.rand(5, 3).astype(np.float32)
    ex.arg_dict["fc_bias"][:] = 0.0
    out = ex.forward(is_train=True, data=rs.rand(4, 3).astype(np.float32),
                     label=np.array([0, 1, 2, 3], np.float32))
    ex.backward()
    return (out[0].asnumpy(),
            {n: ex.grad_dict[n].asnumpy() for n in ("data", "fc_weight",
                                                     "fc_bias")})


def _numpy_op(mx):
    """tests/test_custom_op.py::test_numpy_op."""
    class Sq(mx.operator.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] ** 2

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 2 * in_data[0] * out_grad[0]

    s = Sq()(mx.sym.Variable("x"), name="sq")
    ex = s.simple_bind(ctx=mx.cpu(), x=(3,), grad_req="write")
    xv = np.array([1.0, 2.0, 3.0], np.float32)
    out = ex.forward(is_train=True, x=xv)[0].asnumpy()
    ex.backward(out_grads=mx.nd.array(np.array([1.0, 0.5, -2.0],
                                               np.float32)))
    return out, {"x": ex.grad_dict["x"].asnumpy()}


def _ndarray_op(mx):
    """tests/test_custom_op.py::test_ndarray_op."""
    class Scale(mx.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] * 3.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * 3.0

    s = Scale()(mx.sym.Variable("x"), name="scale")
    ex = s.simple_bind(ctx=mx.cpu(), x=(2, 2), grad_req="write")
    xv = np.arange(4, dtype=np.float32).reshape(2, 2)
    out = ex.forward(is_train=True, x=xv)[0].asnumpy()
    ex.backward(out_grads=mx.nd.array(np.full((2, 2), 0.5, np.float32)))
    return out, {"x": ex.grad_dict["x"].asnumpy()}


@pytest.mark.parametrize("case", [_larger_graph, _numpy_op, _ndarray_op],
                         ids=["larger_graph", "numpy_op", "ndarray_op"])
def test_custom_ops_match_jax(case):
    j_out, j_grads = case(jmx)
    t_out, t_grads = case(tmx)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=TOL)
    assert sorted(t_grads) == sorted(j_grads)
    for n in j_grads:
        np.testing.assert_allclose(t_grads[n], j_grads[n], rtol=0,
                                   atol=TOL, err_msg=n)
    assert np.abs(t_grads["x" if "x" in t_grads else "fc_weight"]).sum() > 0


# ------------------------------------------------------- argument order
def _record_ops(mx, op_type, log):
    op = mx.operator

    class _Rec(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            log.append(("forward", bool(is_train), list(req),
                        [x.asnumpy() for x in in_data],
                        [x.shape for x in out_data], list(aux)))
            a, b = in_data
            self.assign(out_data[0], req[0], a * b)
            self.assign(out_data[1], req[1], a + b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            log.append(("backward", list(req),
                        [x.asnumpy() for x in out_grad],
                        [x.asnumpy() for x in in_data],
                        [x.asnumpy() for x in out_data],
                        [x.asnumpy() for x in in_grad], list(aux)))
            a, b = in_data
            g0, g1 = out_grad
            self.assign(in_grad[0], req[0], g0 * b + g1)
            self.assign(in_grad[1], req[1], g0 * a + g1)

    @op.register(op_type)
    class _RecProp(op.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["prod", "sum"]

        def create_operator(self, ctx, shapes, dtypes):
            return _Rec()


def _record_run(mx):
    log = []
    _record_ops(mx, "parity_record", log)
    sym = mx.sym.Custom(a=mx.sym.Variable("a"), b=mx.sym.Variable("b"),
                        op_type="parity_record", name="rec")
    assert sym.list_outputs() == ["rec_output0", "rec_output1"]
    ex = sym.simple_bind(ctx=mx.cpu(), a=(2, 3), b=(2, 3), grad_req="write")
    rs = np.random.RandomState(2)
    a, b = (rs.randn(2, 3).astype(np.float32) for _ in range(2))
    outs = ex.forward(is_train=True, a=a, b=b)
    g0, g1 = (rs.randn(2, 3).astype(np.float32) for _ in range(2))
    ex.backward(out_grads=[mx.nd.array(g0), mx.nd.array(g1)])
    return (log, [o.asnumpy() for o in outs],
            [ex.grad_dict[n].asnumpy() for n in ("a", "b")])


def test_argument_order_matches_jax():
    j_log, j_outs, j_grads = _record_run(jmx)
    t_log, t_outs, t_grads = _record_run(tmx)
    # the port calls the forward once and the backward once; the JAX
    # package also runs both in forward(is_train=True), with ones as
    # head gradients, and again in backward(out_grads) with the given
    # ones: its last call is the one the port's matches
    assert [e[0] for e in t_log] == ["forward", "backward"]
    assert [e[0] for e in j_log] == ["forward", "backward"] * 2
    (_, j_train, j_req, j_in, j_oshapes, j_aux), j_bwd = j_log[-2:]
    (_, t_train, t_req, t_in, t_oshapes, t_aux), t_bwd = t_log
    assert (t_train, t_req, t_oshapes, t_aux) == \
        (j_train, j_req, j_oshapes, j_aux) == (True, ["write"] * 2,
                                               [(2, 3), (2, 3)], [])
    for t, j in zip(t_in, j_in):
        np.testing.assert_array_equal(t, j)
    assert t_bwd[1] == j_bwd[1] == ["write"] * 2
    assert t_bwd[6] == j_bwd[6] == []
    for k in (2, 3, 4, 5):      # out_grad, in_data, out_data, in_grad
        assert len(t_bwd[k]) == len(j_bwd[k])
        for t, j in zip(t_bwd[k], j_bwd[k]):
            np.testing.assert_allclose(t, j, rtol=0, atol=TOL)
    for t, j in zip(t_outs + t_grads, j_outs + j_grads):
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_loss_head_gets_ones_as_head_gradient(mx):
    """Executor.backward() seeds a need_top_grad=False head with ones in
    both packages."""
    seen = []

    class _Head(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            seen.append(out_grad[0].asnumpy())
            self.assign(in_grad[0], req[0], in_data[0] * 0.0 + 1.0)

    @mx.operator.register("parity_head")
    class _HeadProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def create_operator(self, ctx, shapes, dtypes):
            return _Head()

    sym = mx.sym.Custom(data=mx.sym.Variable("data"),
                        op_type="parity_head", name="head")
    ex = sym.simple_bind(ctx=mx.cpu(), data=(3, 2), grad_req="write")
    ex.forward(is_train=True, data=np.ones((3, 2), np.float32))
    ex.backward()
    np.testing.assert_array_equal(seen[0], np.ones((3, 2), np.float32))
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(),
                                  np.ones((3, 2), np.float32))


# ---------------------------------------------------- registry and rules
@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_shape_rule_infers_the_label(mx):
    sym = mx.sym.Custom(data=mx.sym.Variable("data"),
                        label=mx.sym.Variable("label"),
                        op_type="parity_softmax", name="softmax")
    args, outs, auxs = sym.infer_shape(data=(7, 4))
    assert [tuple(a) for a in args] == [(7, 4), (7,)]
    assert [tuple(o) for o in outs] == [(7, 4)] and list(auxs) == []
    ex = sym.simple_bind(ctx=mx.cpu(), data=(7, 4))
    assert tuple(ex.arg_dict["label"].shape) == (7,)
    assert "parity_softmax" in mx.operator.get_all_registered()


def test_reregistration_clears_the_prop_cache():
    for mx in (jmx, tmx):
        def make(width):
            class _Prop(mx.operator.CustomOpProp):
                def infer_shape(self, in_shape):
                    return in_shape, [(in_shape[0][0], width)], []
            return _Prop

        mx.operator.register("parity_rereg")(make(3))
        sym = mx.sym.Custom(data=mx.sym.Variable("data"),
                            op_type="parity_rereg", name="r")
        assert tuple(sym.infer_shape(data=(2, 5))[1][0]) == (2, 3)
        mx.operator.register("parity_rereg")(make(4))
        assert tuple(sym.infer_shape(data=(2, 5))[1][0]) == (2, 4)


def test_aux_states_refused():
    for mx in (jmx, tmx):
        @mx.operator.register("parity_aux")
        class _AuxProp(mx.operator.CustomOpProp):
            def list_auxiliary_states(self):
                return ["state"]

        sym = mx.sym.Custom(data=mx.sym.Variable("data"),
                            op_type="parity_aux", name="a")
        with pytest.raises(mx.MXNetError, match="auxiliary states"):
            ex = sym.simple_bind(ctx=mx.cpu(), data=(2, 2))
            ex.forward(is_train=False, data=np.ones((2, 2), np.float32))


def test_unknown_op_type_refused():
    with pytest.raises(tmx.MXNetError, match="unknown custom op type"):
        tmx.sym.Custom(data=tmx.sym.Variable("data"), op_type="nope")


def test_assign_reqs():
    op = tmx.operator.CustomOp()
    dst = tmx.nd.array(np.ones(3, np.float32))
    src = tmx.nd.array(np.full(3, 2.0, np.float32))
    op.assign(dst, "null", src)
    np.testing.assert_array_equal(dst.asnumpy(), np.ones(3))
    op.assign(dst, "add", src)
    np.testing.assert_array_equal(dst.asnumpy(), np.full(3, 3.0))
    for req in ("write", "inplace"):
        op.assign(dst, req, src)
        np.testing.assert_array_equal(dst.asnumpy(), np.full(3, 2.0))
    with pytest.raises(tmx.MXNetError, match="unknown req"):
        op.assign(dst, "sideways", src)


def test_custom_graph_json_matches_jax():
    def build(mx):
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                   name="fc")
        return mx.sym.Custom(data=fc, label=mx.sym.Variable("label"),
                             op_type="parity_softmax", name="softmax")

    assert build(tmx).tojson() == build(jmx).tojson()
    loaded = tmx.sym.loads(build(jmx).tojson())
    assert loaded.list_arguments() == ["data", "fc_weight", "fc_bias",
                                       "label"]


# --------------------------------------------- custom_softmax.py, 20 steps
class _PortNumpySoftmax(tmx.operator.CustomOp):
    """examples/numpy_ops/custom_softmax.py's NumpySoftmax, on the port."""

    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0].asnumpy()
        e = np.exp(x - x.max(axis=1, keepdims=True))
        self.assign(out_data[0], req[0],
                    tmx.nd.array(e / e.sum(axis=1, keepdims=True)))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        y = out_data[0].asnumpy()
        label = in_data[1].asnumpy().astype(int)
        g = y.copy()
        g[np.arange(len(label)), label] -= 1.0
        self.assign(in_grad[0], req[0], tmx.nd.array(g))


@tmx.operator.register("numpy_softmax_ce")
class _PortNumpySoftmaxProp(tmx.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return _PortNumpySoftmax()


def _example_steps(mx, steps=20, batch=64):
    rs = np.random.RandomState(0)
    k, d, n = 5, 16, 1024
    centers = rs.randn(k, d).astype(np.float32) * 3.0
    y = rs.randint(0, k, n).astype(np.float32)
    x = centers[y.astype(int)] + rs.randn(n, d).astype(np.float32) * 0.7
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, name="fc1", num_hidden=32)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=k)
    net = mx.sym.Custom(data=net, label=mx.sym.Variable("softmax_label"),
                        op_type="numpy_softmax_ce", name="softmax")
    it = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(0)
    mod.init_params(initializer=mx.init.Uniform(0.01))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    done = 0
    while done < steps:
        for b in it:
            if done == steps:
                break
            mod.forward_backward(b)
            mod.update()
            done += 1
        it.reset()
    args, _ = mod.get_params()
    return {n: v.asnumpy() for n, v in args.items()}


def test_custom_softmax_example_20_steps_match_jax():
    spec = importlib.util.spec_from_file_location(
        "custom_softmax_example",
        os.path.join(ROOT, "examples", "numpy_ops", "custom_softmax.py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    j = _example_steps(jmx)
    t = _example_steps(tmx)
    assert sorted(t) == sorted(j)
    for n in j:
        np.testing.assert_allclose(t[n], j[n], rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=n)
