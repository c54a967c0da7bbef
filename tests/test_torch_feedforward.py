"""The legacy training API in the port (FeedForward, model checkpoints,
DataParallelExecutorManager, the NDArray container format) against the
JAX package's, on the CPU.

- tests/test_feedforward_rtc.py's FeedForward tests in both packages,
  from the same numpy seed (the shuffle and the Xavier draws both come
  from numpy's global generator): parameters after fit within 1e-5,
  predictions within 1e-5 with the same argmax, scores equal.
- Checkpoints: either package's `save` loads in the other and predicts
  the same; `.params` and `-symbol.json` files are byte-identical for
  equal arrays and graphs.
- DataParallelExecutorManager over two host contexts in both packages:
  the batch split, outputs, gradients, metric and averaged parameters
  agree within 1e-6.
- NDArray arithmetic, onehot_encode and the container's dtypes.
"""
import os
import struct

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

FIT_TOL = 1e-5
TOL = 1e-6


def _toy_data(n=256, seed=3):
    rs = np.random.RandomState(seed)
    X = rs.rand(n, 10).astype(np.float32)
    y = (X.sum(axis=1) > 5).astype(np.float32)
    return X, y


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc, act_type="tanh", name="act1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _fit(mx, num_epoch=20):
    X, y = _toy_data()
    np.random.seed(7)
    model = mx.FeedForward(
        _mlp(mx), ctx=mx.cpu(), num_epoch=num_epoch, numpy_batch_size=32,
        optimizer="sgd", learning_rate=0.5, initializer=mx.init.Xavier())
    model.fit(X, y)
    return model


@pytest.fixture(scope="module")
def fitted():
    return _fit(jmx), _fit(tmx)


def _np(params):
    return {k: v.asnumpy() for k, v in params.items()}


def test_feedforward_fit_matches_jax(fitted):
    jm, tm = fitted
    ja, ta = _np(jm.arg_params), _np(tm.arg_params)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=FIT_TOL, atol=FIT_TOL,
                                   err_msg=k)
    assert tm.aux_params == {} and jm.aux_params == {}


def test_feedforward_predict_and_score_match_jax(fitted):
    jm, tm = fitted
    X, y = _toy_data()
    jp, tp = jm.predict(X), tm.predict(X)
    assert tp.shape == jp.shape == (256, 2)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=FIT_TOL)
    np.testing.assert_array_equal(tp.argmax(1), jp.argmax(1))
    jacc = jm.score(jmx.io.NDArrayIter(X, y, batch_size=32))
    tacc = tm.score(tmx.io.NDArrayIter(X, y, batch_size=32))
    assert tacc == jacc and tacc > 0.8
    # score with a metric object, and a partial predict
    tacc2 = tm.score(tmx.io.NDArrayIter(X, y, batch_size=32),
                     eval_metric=tmx.metric.Accuracy())
    assert tacc2 == tacc
    np.testing.assert_array_equal(tm.predict(X, num_batch=2), tp[:64])


def test_feedforward_create_matches_jax():
    X, y = _toy_data()
    models = []
    for mx in (jmx, tmx):
        np.random.seed(11)
        models.append(mx.FeedForward.create(
            _mlp(mx), X, y, ctx=mx.cpu(), num_epoch=4, learning_rate=0.5,
            initializer=mx.init.Xavier()))
    ja, ta = _np(models[0].arg_params), _np(models[1].arg_params)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=FIT_TOL, atol=FIT_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("writer, reader", [(jmx, tmx), (tmx, jmx),
                                            (tmx, tmx)],
                         ids=["jax_to_torch", "torch_to_jax",
                              "torch_to_torch"])
def test_checkpoint_loads_across_packages(fitted, tmp_path, writer,
                                          reader):
    model = fitted[0] if writer is jmx else fitted[1]
    X, _ = _toy_data()
    want = model.predict(X)
    prefix = str(tmp_path / "ff")
    model.save(prefix, 8)
    loaded = reader.FeedForward.load(prefix, 8, ctx=reader.cpu())
    assert loaded.symbol.tojson() == model.symbol.tojson()
    got = loaded.predict(X)
    if reader is writer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _equal_arrays(mx):
    rs = np.random.RandomState(4)
    return {"arg:w": mx.nd.array(rs.randn(3, 4).astype(np.float32)),
            "arg:h": mx.nd.array(rs.randn(5).astype(np.float16)),
            "aux:i": mx.nd.array(rs.randint(-9, 9, (2, 2)).astype(np.int32)),
            "aux:b": mx.nd.array(rs.randint(0, 255, 6).astype(np.uint8)),
            "arg:s": mx.nd.array(rs.randint(-9, 9, 3).astype(np.int8)),
            "arg:z": mx.nd.array(np.zeros((0, 3), np.float32))}


_FRESH_JSON = (
    "import sys; sys.path.insert(0, 'tests')\n"
    "import mxnet_tpu as jmx, mxnet_tpu_torch as tmx\n"
    "from test_torch_feedforward import _mlp\n"
    "sys.stdout.write(_mlp(jmx).tojson() + '\\0' + _mlp(tmx).tojson())\n")


def _symbol_state(sym_module):
    """The process-global state a package's graph construction reads:
    the open attribute scopes and name prefixes of this thread."""
    return {"attr_scope": sym_module.AttrScope.current_attrs(),
            "prefix": sym_module.Prefix.current_prefix()}


def _symbol_mismatch(tb, jb):
    """What a mismatch of the two -symbol.json files tells: each file's
    first difference from the JSON a fresh process gives for the same
    graph, this process's scope state in both packages, and both
    files."""
    import subprocess
    import sys

    import mxnet_tpu.symbol as jsym
    import mxnet_tpu_torch.symbol as tsym

    res = subprocess.run(
        [sys.executable, "-c", _FRESH_JSON], capture_output=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    fresh = res.stdout.split(b"\0")
    if len(fresh) != 2:
        fresh = [b"", b""]

    def first_diff(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))

    return (f"-symbol.json: torch differs from a fresh process's JSON at "
            f"byte {first_diff(tb, fresh[1])}, jax at "
            f"{first_diff(jb, fresh[0])}; scopes: jax "
            f"{_symbol_state(jsym)}, torch {_symbol_state(tsym)}"
            f"; torch {tb!r}, jax {jb!r}")


def test_params_and_symbol_files_byte_identical(tmp_path):
    paths = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        arrays = _equal_arrays(mx)
        arg = {k[4:]: v for k, v in arrays.items() if k.startswith("arg:")}
        aux = {k[4:]: v for k, v in arrays.items() if k.startswith("aux:")}
        prefix = str(tmp_path / name)
        mx.model.save_checkpoint(prefix, 3, _mlp(mx), arg, aux)
        mx.nd.save(f"{prefix}.list", list(arrays.values()))
        paths[name] = prefix
    for suffix in ("-symbol.json", "-0003.params", ".list"):
        with open(paths["jax"] + suffix, "rb") as f:
            jb = f.read()
        with open(paths["torch"] + suffix, "rb") as f:
            tb = f.read()
        if suffix == "-symbol.json":
            assert tb == jb, _symbol_mismatch(tb, jb)
        assert tb == jb, f"{suffix}: torch {tb!r}, jax {jb!r}"
    sym, arg, aux = tmx.model.load_checkpoint(paths["jax"], 3)
    assert sym.list_arguments() == _mlp(tmx).list_arguments()
    assert list(arg) == ["w", "h", "s", "z"] and list(aux) == ["i", "b"]
    for k, v in _equal_arrays(jmx).items():
        got = (arg if k.startswith("arg:") else aux)[k[4:]]
        assert got.dtype == v.asnumpy().dtype and got.context == tmx.cpu()
        np.testing.assert_array_equal(got.asnumpy(), v.asnumpy())


def _device_fields(raw):
    """The (device type, id) of each array of a container file."""
    (n,) = struct.unpack_from("<Q", raw, 16)
    pos, out = 24, []
    for _ in range(n):
        (ndim,) = struct.unpack_from("<I", raw, pos + 4)
        pos += 8 + 8 * ndim
        out.append(struct.unpack_from("<ii", raw, pos))
        (nbytes,) = struct.unpack_from("<Q", raw, pos + 12)
        pos += 20 + nbytes
    return out


def test_container_formats_and_device_field(tmp_path):
    rs = np.random.RandomState(5)
    t = torch.from_numpy(rs.randn(4, 3).astype(np.float32))
    arrays = [tmx.nd.NDArray(t.to(torch.bfloat16)),
              tmx.nd.NDArray(t.double()),
              tmx.nd.NDArray(t.to(torch.int64)),
              tmx.nd.NDArray(t.clone(), ctx=tmx.gpu(0))]
    path = str(tmp_path / "x.nd")
    tmx.nd.save(path, arrays)
    loaded = tmx.nd.load(path)
    assert isinstance(loaded, list) and len(loaded) == 4
    for a, b in zip(arrays, loaded):
        assert b.data.dtype == a.data.dtype and b.context == tmx.cpu()
        assert torch.equal(b.data, a.data)
    with open(path, "rb") as f:
        raw = f.read()
    # a gpu(0) array records (device type 2, id 0), the host ones (1, 0)
    assert _device_fields(raw) == [(1, 0), (1, 0), (1, 0), (2, 0)]
    again = tmx.nd.load_frombuffer(raw)
    assert all(torch.equal(a.data, b.data) for a, b in zip(loaded, again))
    with pytest.raises(MXNetError, match="invalid NDArray file buffer"):
        tmx.nd.load_frombuffer(b"\0" * 16)
    single = str(tmp_path / "one.nd")
    tmx.nd.save(single, arrays[1])
    assert torch.equal(tmx.nd.load(single)[0].data, arrays[1].data)
    with open(single, "r+b") as f:
        f.write(b"\0")
    with pytest.raises(MXNetError, match="invalid NDArray file"):
        tmx.nd.load(single)


# ------------------------------------------------------ executor manager
def _manager_run(mx):
    X, y = _toy_data()
    it = mx.io.NDArrayIter(X, y, batch_size=32)
    mgr = mx.executor_manager.DataParallelExecutorManager(
        _mlp(mx), [mx.cpu(0), mx.cpu(1)], it)
    arg_shapes, _, _ = _mlp(mx).infer_shape(data=(32, 10))
    shapes = dict(zip(_mlp(mx).list_arguments(), arg_shapes))
    rs = np.random.RandomState(0)
    init_params = {n: rs.uniform(-0.1, 0.1, shapes[n]).astype(np.float32)
                   for n in mgr.param_names}
    mgr.set_params(init_params, {})
    batch = next(iter(it))
    mgr.load_data_batch(batch)
    mgr.forward(is_train=True)
    mgr.backward()
    m = mx.metric.Accuracy()
    mgr.update_metric(m, batch.label)
    out = {n: mx.nd.zeros(shapes[n], ctx=mx.cpu()) for n in mgr.param_names}
    mgr.copy_to(out, {})
    return {"names": mgr.param_names, "num_inst": m.num_inst,
            "acc": m.get()[1],
            "slices": [(s.start, s.stop) for s in mgr.execgrp.slices],
            "outputs": mgr.curr_execgrp.get_outputs()[0].asnumpy(),
            "grads": [[g.asnumpy() for g in block]
                      for block in mgr.grad_arrays],
            "params": _np(out)}


def test_executor_manager_matches_jax():
    j, t = _manager_run(jmx), _manager_run(tmx)
    assert t["names"] == j["names"] == ["fc1_weight", "fc1_bias",
                                        "fc2_weight", "fc2_bias"]
    assert t["num_inst"] == j["num_inst"] == 32
    assert t["slices"] == j["slices"] == [(0, 16), (16, 32)]
    assert t["acc"] == j["acc"]
    np.testing.assert_allclose(t["outputs"], j["outputs"], rtol=0, atol=TOL)
    assert t["outputs"].shape == (32, 2)
    for tb, jb in zip(t["grads"], j["grads"]):
        assert len(tb) == len(jb) == 2
        for tg, jg in zip(tb, jb):
            np.testing.assert_allclose(tg, jg, rtol=0, atol=TOL)
    for k in j["params"]:
        np.testing.assert_allclose(t["params"][k], j["params"][k], rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("batch, work", [(32, [1, 1]), (10, [1, 2, 3]),
                                         (7, [3, 1]), (5, [1])])
def test_split_input_slice_matches_jax(batch, work):
    assert tmx.executor_manager._split_input_slice(batch, work) == \
        jmx.executor_manager._split_input_slice(batch, work)


def test_executor_manager_refusals():
    X, y = _toy_data()
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    with pytest.raises(MXNetError, match="work_load_list"):
        tmx.executor_manager.DataParallelExecutorManager(
            _mlp(tmx), [tmx.cpu()], it, work_load_list=[1, 1])
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2,
                                 name="fc")
    dup = tmx.sym.Group([net, tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=2, name="fc")])
    with pytest.raises(MXNetError, match="duplicated argument"):
        tmx.executor_manager.DataParallelExecutorManager(dup, [tmx.cpu()],
                                                         it)


# ------------------------------------------------------- model refusals
def test_kvstores_and_elastic_refused():
    assert tmx.model._create_kvstore(None, 1, {}) == (None, False)
    assert tmx.model._create_kvstore("local", 1, {}) == (None, False)
    for kv, ndev in (("local", 2), ("device", 1), ("dist_sync", 1),
                     ("tpu", 1)):
        with pytest.raises(MXNetError, match="A.5.2"):
            tmx.model._create_kvstore(kv, ndev, {})
    with pytest.raises(MXNetError, match="A.10"):
        tmx.model.fit_elastic("localhost:1", None)
    X, y = _toy_data()
    with pytest.raises(MXNetError, match="KVStore"):
        tmx.FeedForward(_mlp(tmx), ctx=tmx.cpu(), num_epoch=1).fit(
            X, y, kvstore="dist_sync")
    with pytest.raises(MXNetError, match="not been trained"):
        tmx.FeedForward(_mlp(tmx), ctx=tmx.cpu()).predict(X)


def test_feedforward_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    X, y = _toy_data()
    model = tmx.FeedForward(_mlp(tmx), num_epoch=1)
    assert model.ctx == [tmx.gpu(0)] == [tmx.default_context()]
    with pytest.raises(MXNetError, match="no CUDA device"):
        model.fit(X, y)


def test_model_update_helpers_match_jax():
    """_update_params with no store runs the updater once per (key,
    device copy), with the reference's faked index."""
    calls = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        seen = []
        w = [[mx.nd.array(np.ones(2, np.float32))] * 2,
             [mx.nd.array(np.ones(3, np.float32))] * 2]
        g = [[mx.nd.array(np.ones(2, np.float32))] * 2, [None, None]]
        mx.model._update_params(w, g, lambda i, gr, wt: seen.append(i), 2)
        calls[name] = seen
    assert calls["torch"] == calls["jax"] == [0, 1]


def test_update_params_multi_tensor_equals_per_index():
    """An Updater whose optimizer has update_multi (the path Module.update
    takes) gives the weights and states of one updater call per (key,
    device copy)."""
    rs = np.random.RandomState(8)
    shapes = [(3, 4), (5,), (2, 2)]
    w0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    steps = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    out = {}
    for path in ("multi", "per_index"):
        opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3)
        updater = tmx.optimizer.get_updater(opt)
        call = updater if path == "multi" else (
            lambda i, g, w: updater(i, g, w))
        w = [[tmx.nd.array(a, ctx=tmx.cpu()) for _ in range(2)] for a in w0]
        for grads in steps:
            g = [[tmx.nd.array(a * (k + 1), ctx=tmx.cpu()) for k in range(2)]
                 for a in grads[:2]] + [[None, None]]
            tmx.model._update_params(w, g, call, 2)
        out[path] = ([[c.asnumpy() for c in block] for block in w],
                     sorted(updater.states))
    assert out["multi"][1] == out["per_index"][1] == [0, 1, 2, 3]
    for mb, pb in zip(out["multi"][0], out["per_index"][0]):
        for m, p in zip(mb, pb):
            np.testing.assert_allclose(m, p, rtol=0, atol=TOL)
    # the parameter without a gradient stayed where it was
    assert all(np.array_equal(c, w0[2]) for c in out["multi"][0][2])


def test_module_and_feedforward_refuse_two_devices():
    """Several devices wait for the KVStore: Module and FeedForward refuse
    them whatever the kvstore, rather than train on one device's share
    of each batch."""
    X, y = _toy_data()
    two = [tmx.cpu(0), tmx.cpu(1)]
    with pytest.raises(MXNetError, match="A.5.2"):
        tmx.mod.Module(_mlp(tmx), context=two)
    for kvstore in (None, "local"):
        with pytest.raises(MXNetError, match="A.5.2"):
            tmx.FeedForward(_mlp(tmx), ctx=two, num_epoch=1).fit(
                X, y, kvstore=kvstore)


# --------------------------------------------------------------- NDArray
def test_ndarray_arithmetic_and_onehot_match_jax():
    rs = np.random.RandomState(6)
    a = rs.randn(3, 4).astype(np.float32)
    b = rs.randn(3, 4).astype(np.float32) + 3.0
    results = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        x, y = mx.nd.array(a), mx.nd.array(b)
        out = [x + y, x - y, x * y, x / y, x + 2.0, 2.0 + x, x - 1.5,
               1.5 - x, x * 3.0, 3.0 * x, x / 4.0, 4.0 / y, -x]
        z = mx.nd.array(a)
        z += y
        z -= 1.0
        z *= y
        z /= 2.0
        out.append(z)
        idx = mx.nd.array(np.array([1, 0, 3, 7], np.float32))
        oh = mx.nd.zeros((4, 5), ctx=mx.cpu())
        out.append(mx.nd.onehot_encode(idx, oh))
        out.append(oh)
        results[name] = [o.asnumpy() for o in out]
    for t, j in zip(results["torch"], results["jax"]):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    tmx.nd.waitall()
