"""The one-shot serving tier of the port (`mxnet_tpu_torch.serving`:
BucketSpec, DynamicBatcher, ModelRegistry, ModelServer, ServingStats)
against the JAX package's, on the CPU.

- tests/test_serving.py's 14 tests replayed on the port: the reference
  test source with `mxnet_tpu` read as `mxnet_tpu_torch`, run under
  `with mx.cpu():` (the port's Predictor binds to the current context,
  the card by default), each with the reference file's fixture (the
  MXNET_SERVING_* knobs unset, the stats table cleared).
- tests/test_decoding.py's `test_model_server_integration` and
  `test_duplicate_decoder_version_rejected`, on the port's ModelServer
  with `device="cpu"`, against dense greedy decoding of the same
  weights.
- Parity with the JAX package: one checkpoint (Embedding -> mean ->
  FullyConnected, and a BatchNorm convolution net) served through both
  packages' ModelServer from the same request stream, every per-request
  output within TOL = 1e-5 (absolute and relative: the same float32 ops,
  reduced in other orders); BucketSpec's shapes, assembled feeds and
  per-request slices bit-equal; `serving_stats()` keys equal; and the
  decode streams of both servers' decoders equal token for token.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import inspect  # noqa: E402
import pathlib  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import decoding as jdec  # noqa: E402
from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu_torch import decoding as tdec  # noqa: E402
from mxnet_tpu_torch import serving as tserving  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _own_jax_disk_root(tmp_path_factory):
    """The JAX references build under an empty exec-cache disk root of
    this module's own, with no bundle overlay mounted: a program another
    test left in the worker's shared root (tests/conftest.py) or in a
    bundle it mounted, built for another device layout, is never
    replayed here."""
    from mxnet_tpu import exec_cache_disk as jdisk

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_EXEC_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_exec_cache")))
        mp.setattr(jdisk, "_overlays", [])
        yield


ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
SERVING_ENV = ("MXNET_SERVING_MAX_BATCH", "MXNET_SERVING_MAX_WAIT_US",
               "MXNET_SERVING_QUEUE_CAP", "MXNET_SERVING_BUCKETS",
               "MXNET_SERVING_LENGTH_BUCKETS")


def _replay(test_file):
    """The namespace of a reference test file run against the port."""
    path = ROOT / "tests" / test_file
    src = path.read_text().replace("mxnet_tpu", "mxnet_tpu_torch")
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


SERVING = _replay("test_serving.py")
SERVING_TESTS = sorted(n for n in SERVING if n.startswith("test_"))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in SERVING_ENV:
        monkeypatch.delenv(var, raising=False)
    tserving.stats._registry.clear()
    jserving.stats._registry.clear()
    yield


def test_every_reference_serving_test_is_replayed():
    assert len(SERVING_TESTS) == 14, SERVING_TESTS


@pytest.mark.parametrize("name", SERVING_TESTS)
def test_serving_replayed(name, tmp_path, monkeypatch):
    fn = SERVING[name]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path),
                                ("monkeypatch", monkeypatch))
              if k in params}
    with tmx.cpu():
        fn(**kwargs)


# ------------------------------------------------------- bucket spec
def test_bucket_spec_shapes_and_padding_bit_equal():
    """Same grid, same requests: the same cells, the same assembled
    feeds (values, dtypes, padding) and the same per-request slices."""
    from mxnet_tpu.serving.batcher import _Request as JRequest
    from mxnet_tpu_torch.serving.batcher import _Request as TRequest

    specs = [({"data": ("L",), "mask": ("L", 3)}, (1, 2, 4), (4, 8, 16)),
             ({"image": (3, 5, 5)}, (1, 2, 4, 8), None)]
    rs = np.random.RandomState(0)
    for input_specs, bb, lb in specs:
        js = jserving.BucketSpec(input_specs, bb, length_buckets=lb,
                                 pad_value=-1.0)
        ts = tserving.BucketSpec(input_specs, bb, length_buckets=lb,
                                 pad_value=-1.0)
        assert js.all_buckets() == ts.all_buckets()
        for cell in ts.all_buckets():
            assert js.input_shapes(*cell) == ts.input_shapes(*cell)
        reqs = {"j": [], "t": []}
        for n in (3, 1, 7):
            if ts.ragged:
                inputs = {"data": rs.randint(0, 50, (n,)).astype(np.int32),
                          "mask": rs.rand(n, 3).astype(np.float32)}
            else:
                inputs = {"image": rs.rand(3, 5, 5).astype(np.float32)}
            length = ts.request_length(inputs)
            assert length == js.request_length(inputs)
            bucket = ts.length_bucket(length)
            assert bucket == js.length_bucket(length)
            for key, cls in (("j", JRequest), ("t", TRequest)):
                r = cls(inputs, None, None, length, bucket)
                reqs[key].append(r)
        # one bucket per group, as the batcher flushes them
        groups = {}
        for rj, rt in zip(reqs["j"], reqs["t"]):
            groups.setdefault(rt.bucket, []).append((rj, rt))
        for pairs in groups.values():
            jr = [p[0] for p in pairs]
            tr = [p[1] for p in pairs]
            jf, jb, jl, jreal, jpad = js.assemble(jr)
            tf, tb, tl, treal, tpad = ts.assemble(tr)
            assert (jb, jl, jreal, jpad) == (tb, tl, treal, tpad)
            for name in jf:
                assert jf[name].dtype == tf[name].dtype
                assert np.array_equal(jf[name], tf[name]), name
            for row, (a, b) in enumerate(zip(jr, tr)):
                a.row = b.row = row
            outs = [next(iter(jf.values())) * 2.0]
            jo = js.disassemble(outs, jr, jl)
            to = ts.disassemble(outs, tr, tl)
            for a, b in zip(jo, to):
                assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_default_buckets_and_pick_bucket_equal():
    for n in range(1, 20):
        assert tserving.default_batch_buckets(n) == \
            jserving.default_batch_buckets(n)
    for v in range(1, 9):
        assert tserving.pick_bucket(v, (1, 2, 4, 8)) == \
            jserving.pick_bucket(v, (1, 2, 4, 8))


# --------------------------------------------------- served outputs
def _text_net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Embedding(data, input_dim=50, output_dim=8, name="embed")
    net = mx.sym.mean(net, axis=1)
    return mx.sym.FullyConnected(net, num_hidden=5, name="fc")


def _conv_net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                             name="conv")
    net = mx.sym.BatchNorm(net, name="bn")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="avg")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=3,
                                name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _checkpoint(mx, net, tmp_path, tag, **shapes):
    rs = np.random.RandomState(3)
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    args = {n: mx.nd.array(rs.normal(0, 0.3, s).astype(np.float32),
                           ctx=mx.cpu())
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in shapes and not n.endswith("label")}
    auxs = {n: mx.nd.array(rs.uniform(0.5, 1.5, s).astype(np.float32),
                           ctx=mx.cpu())
            for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    prefix = str(tmp_path / tag)
    mx.model.save_checkpoint(prefix, 1, net, args, auxs)
    return prefix


def _serve(serving, mx, prefix, specs, requests, **load_kw):
    """Load the checkpoint into a server and send the requests from 3
    client threads; the per-request outputs in request order."""
    srv = serving.ModelServer(max_batch=4, max_wait_us=2000)
    srv.load_checkpoint("m", prefix, 1, input_specs=specs, ctx=mx.cpu(),
                        **load_kw)
    outs = [None] * len(requests)

    def client(idx):
        futs = [(i, srv.submit("m", requests[i])) for i in idx]
        for i, f in futs:
            outs[i] = f.result(timeout=60)

    threads = [threading.Thread(target=client,
                                args=(range(k, len(requests), 3),))
               for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = serving.serving_stats()["m:1"]
    srv.stop()
    return outs, snap


@pytest.mark.parametrize("case", ["ragged_text", "fixed_conv"])
def test_server_outputs_match_reference(case, tmp_path):
    rs = np.random.RandomState(5)
    if case == "ragged_text":
        specs = {"data": ("L",)}
        kw = dict(input_dtypes={"data": "int32"}, length_buckets=(4, 8))
        requests = [{"data": rs.randint(0, 50, (n,)).astype(np.int32)}
                    for n in rs.randint(1, 9, 18)]
        shapes = {"data": (1, 8)}
        build = _text_net
    else:
        specs = {"data": (2, 6, 6)}
        kw = {}
        requests = [{"data": rs.rand(2, 6, 6).astype(np.float32)}
                    for _ in range(13)]
        shapes = {"data": (1, 2, 6, 6)}
        build = _conv_net
    got = {}
    for key, mx, serving in (("j", jmx, jserving), ("t", tmx, tserving)):
        prefix = _checkpoint(mx, build(mx), tmp_path, key, **shapes)
        got[key] = _serve(serving, mx, prefix, specs, requests, **kw)
    (jo, js), (to, ts) = got["j"], got["t"]
    for i, (a, b) in enumerate(zip(jo, to)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape, (i, x.shape, y.shape)
            np.testing.assert_allclose(y, x, rtol=TOL, atol=TOL)
    assert sorted(ts) == sorted(js)
    assert ts["completed"] == js["completed"] == len(requests)
    assert ts["traces_since_warmup"] == js["traces_since_warmup"] == 0
    assert ts["calibration_skipped"] == 0


def test_serving_stats_keys_equal():
    rs = np.random.RandomState(1)
    net_j, net_t = jmx.sym.Variable("data") * 2.0, \
        tmx.sym.Variable("data") * 2.0
    snaps = {}
    for key, mx, serving, net in (("j", jmx, jserving, net_j),
                                  ("t", tmx, tserving, net_t)):
        with serving.ModelServer(max_batch=2, max_wait_us=1000) as srv:
            srv.load("ew", net.tojson(), {}, input_specs={"data": ("L",)},
                     length_buckets=(4,), ctx=mx.cpu())
            srv.predict("ew", {"data": rs.rand(3).astype(np.float32)},
                        timeout=30)
            snaps[key] = serving.serving_stats()
    assert list(snaps["t"]) == list(snaps["j"]) == ["ew:1"]
    assert sorted(snaps["t"]["ew:1"]) == sorted(snaps["j"]["ew:1"])


# ----------------------------------------------------------- decoders
DCFG = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
            max_len=64)
DKW = dict(max_batch=2, page_size=4, num_pages=32, page_buckets=(1, 2, 4),
           max_tokens=8)


def _tparams():
    cfg = tdec.DecoderConfig(**DCFG)
    return tdec.init_decoder_params(cfg, seed=0), cfg


def _greedy(params, cfg, prompt, n):
    """Dense greedy decoding of the port's weights (the oracle of
    tests/test_decoding.py's `_ref_greedy`)."""
    import torch

    model = tdec.params_from_jax(params, cfg, torch.device("cpu"))
    toks, out = list(prompt), []
    for _ in range(n):
        lg = tdec.reference_logits(model, [toks], cfg)
        nxt = int(lg[0, -1].argmax())
        if nxt == cfg.eos_id:
            break
        out.append(nxt)
        toks.append(nxt)
    return out


def test_model_server_integration_replayed():
    """tests/test_decoding.py::test_model_server_integration on the
    port."""
    params, cfg = _tparams()
    with tserving.ModelServer() as srv:
        srv.load_decoder("lm", params, cfg, device="cpu", **DKW)
        out = srv.generate("lm", [5, 6, 7], max_new_tokens=4, timeout=60)
        assert out == _greedy(params, cfg, [5, 6, 7], 4)
        assert list(srv.stream("lm", [3, 4], max_new_tokens=3,
                               timeout=60)) == _greedy(params, cfg, [3, 4], 3)
        with pytest.raises(tserving.ServingError):
            srv.submit("lm", {"data": np.zeros((3,), np.int32)})
        assert "lm:1" in tdec.decoding_stats()
        srv.unload("lm")
        assert tdec.decoding_stats() == {}
        with pytest.raises(tserving.ServingError):
            srv.generate("lm", [5, 6])


def test_duplicate_decoder_version_rejected_replayed():
    params, cfg = _tparams()
    with tserving.ModelServer() as srv:
        srv.load_decoder("lm", params, cfg, device="cpu", max_batch=2,
                         page_size=4, num_pages=16, page_buckets=(1, 2))
        with pytest.raises(tserving.ServingError):
            srv.load_decoder("lm", params, cfg, device="cpu", max_batch=2,
                             page_size=4, num_pages=16, page_buckets=(1, 2))
        srv.unload("lm")


def test_server_decode_streams_equal_reference():
    """The same weights behind both packages' ModelServer: generate,
    stream and submit_decode give the same tokens, and unload stops the
    decoder's scheduler thread."""
    jcfg = jdec.DecoderConfig(**DCFG)
    params, tcfg = _tparams()
    jparams = jdec.init_decoder_params(jcfg, seed=0)
    prompts = [[5, 6, 7], [3, 4], [9, 1, 2, 8, 11], [30]]
    got = {}
    for key, serving, p, cfg, kw in (
            ("j", jserving, jparams, jcfg, {}),
            ("t", tserving, params, tcfg, {"device": "cpu"})):
        with serving.ModelServer() as srv:
            model = srv.load_decoder("lm", p, cfg, **kw, **DKW)
            futs = [srv.submit_decode("lm", q, max_new_tokens=6)
                    for q in prompts]
            outs = [f.result(60) for f in futs]
            outs.append(list(srv.stream("lm", prompts[0], max_new_tokens=6,
                                        timeout=60)))
            outs.append(srv.generate("lm", prompts[2], max_new_tokens=6,
                                     timeout=60))
            got[key] = outs
            if key == "t":
                thread = model.scheduler._thread
                assert thread.is_alive()
                srv.unload("lm")
                assert not thread.is_alive()
    assert got["t"] == got["j"]
