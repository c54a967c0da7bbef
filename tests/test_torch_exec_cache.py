"""The port's bind-plan cache (mxnet_tpu_torch/exec_cache.py) against the
JAX package's exec_cache, on the CPU.

- tests/test_exec_cache.py's tests replayed on the port (the reference
  source with `mxnet_tpu` read as `mxnet_tpu_torch`, under
  `with mx.cpu():`), each after the reference file's fixture (the cache
  emptied, its counters zeroed, MXNET_EXEC_CACHE, MXNET_EXEC_CACHE_SIZE
  and MXNET_BACKWARD_DO_MIRROR unset).
- The same sequence of binds in both packages gives equal `hits`,
  `misses`, `traces`, `evictions`, `shared_hits` and
  `canonical_collisions`, and the disk tier's `disk_hits`, `disk_misses`
  and `disk_writes` (the suite's conftest mounts a disk root in every
  test process), after every step: binds and rebinds, reshapes
  there and back, a BucketingModule's bucket revisits, shared_exec, the
  cache switched off, and an LRU of 2. The port's `jit_builds` and
  `graph_replays` stay 0 (an eager walk has no jit closures or traced
  replays).
- Executors that share a plan compute the same outputs, within TOL =
  1e-5 of the JAX package's.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import inspect  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import exec_cache as jcache  # noqa: E402
from mxnet_tpu_torch import exec_cache as tcache  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
COUNTERS = ("hits", "misses", "traces", "evictions", "shared_hits",
            "canonical_collisions", "disk_hits", "disk_misses",
            "disk_writes")


def _replay(test_file):
    path = ROOT / "tests" / test_file
    src = path.read_text().replace("mxnet_tpu", "mxnet_tpu_torch")
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


CACHE = _replay("test_exec_cache.py")
CACHE_TESTS = sorted(n for n in CACHE if n.startswith("test_"))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXNET_EXEC_CACHE", "MXNET_EXEC_CACHE_SIZE",
                "MXNET_BACKWARD_DO_MIRROR"):
        monkeypatch.delenv(var, raising=False)
    for cache in (jcache, tcache):
        cache.clear()
        cache.reset_stats()
    yield
    for cache in (jcache, tcache):
        cache.clear()
        cache.reset_stats()


def test_every_reference_cache_test_is_replayed():
    assert len(CACHE_TESTS) == 10, CACHE_TESTS


@pytest.mark.parametrize("name", CACHE_TESTS)
def test_exec_cache_replayed(name, monkeypatch):
    fn = CACHE[name]
    kwargs = {"monkeypatch": monkeypatch} \
        if "monkeypatch" in inspect.signature(fn).parameters else {}
    with tmx.cpu():
        fn(**kwargs)


def _counters(cache):
    s = cache.cache_stats()
    return {k: s.get(k) for k in COUNTERS}


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def _gen(mx):
    def gen(key):
        data = mx.sym.Variable("data")
        emb = mx.sym.Embedding(data, input_dim=17, output_dim=8,
                               name="emb")
        net = mx.sym.SoftmaxOutput(
            mx.sym.FullyConnected(mx.sym.mean(emb, axis=1), num_hidden=3,
                                  name="fc"), name="softmax")
        return net, ("data",), ("softmax_label",)
    return gen


def _binds(mx):
    """Binds, rebinds and reshapes: yields after each step."""
    net = _mlp(mx)
    e1 = net.simple_bind(mx.cpu(), data=(4, 3))
    yield "bind"
    net.simple_bind(mx.cpu(), data=(4, 3))
    yield "rebind"
    _mlp(mx).simple_bind(mx.cpu(), data=(4, 3))
    yield "rebuilt symbol"
    e2 = e1.reshape(data=(2, 3))
    yield "reshape"
    e3 = e2.reshape(data=(4, 3))
    yield "reshape back"
    e3.reshape(data=(4, 3))
    yield "reshape to the same shapes"
    net.simple_bind(mx.cpu(), data=(4, 3), shared_exec=e1)
    yield "shared_exec"
    net.simple_bind(mx.cpu(), data=(2, 3), shared_exec=e1)
    yield "shared_exec, other shapes"
    net.simple_bind(mx.cpu(), grad_req="null", data=(4, 3))
    yield "grad_req null"
    x = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    e3.forward(is_train=False, data=mx.nd.array(x, ctx=mx.cpu()))
    e1.forward(is_train=False, data=mx.nd.array(x, ctx=mx.cpu()))
    assert e3._compiled is e1._compiled
    np.testing.assert_array_equal(e3.outputs[0].asnumpy(),
                                  e1.outputs[0].asnumpy())
    yield e1.outputs[0].asnumpy()


def _buckets(mx):
    bm = mx.mod.BucketingModule(_gen(mx), default_bucket_key=9,
                                context=mx.cpu())
    bm.bind(data_shapes=[("data", (8, 9))],
            label_shapes=[("softmax_label", (8,))])
    yield "bind default bucket"
    bm.init_params(mx.initializer.Xavier())
    for cycle in range(2):
        for T in (4, 6, 9):
            rs = np.random.RandomState(T)
            bm.forward(mx.io.DataBatch(
                data=[mx.nd.array(rs.randint(0, 17, (8, T))
                                  .astype(np.float32), ctx=mx.cpu())],
                label=[mx.nd.array(rs.randint(0, 3, 8).astype(np.float32),
                                   ctx=mx.cpu())],
                bucket_key=T, provide_data=[("data", (8, T))],
                provide_label=[("softmax_label", (8,))]))
            bm.backward()
            yield f"cycle {cycle} bucket {T}"


def _lru(mx):
    net = _mlp(mx)
    for b in (2, 3, 4, 2, 4, 3):
        net.simple_bind(mx.cpu(), data=(b, 3))
        yield f"bind {b}"


def _cache_off(mx):
    net = _mlp(mx)
    for _ in range(2):
        net.simple_bind(mx.cpu(), data=(4, 3))
        yield "bind with the cache off"


@pytest.mark.parametrize("sequence,env", [
    (_binds, {}), (_buckets, {}), (_lru, {"MXNET_EXEC_CACHE_SIZE": "2"}),
    (_cache_off, {"MXNET_EXEC_CACHE": "0"})],
    ids=["binds", "buckets", "lru_of_2", "cache_off"])
def test_counters_equal_reference(sequence, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tmx.random.seed(0)
    steps = {"j": [], "t": []}
    last = {}
    for key, mx, cache in (("j", jmx, jcache), ("t", tmx, tcache)):
        for label in sequence(mx):
            if isinstance(label, np.ndarray):
                last[key] = label
                continue
            steps[key].append((label, _counters(cache)))
    assert steps["t"] == steps["j"]
    if last:
        np.testing.assert_allclose(last["t"], last["j"], rtol=TOL, atol=TOL)
    s = tcache.cache_stats()
    assert s["jit_builds"] == s["graph_replays"] == 0
    assert s["size"] == jcache.cache_stats()["size"]


def test_entries_carry_digests():
    net = _mlp(tmx)
    e1 = net.simple_bind(tmx.cpu(), data=(4, 3))
    net.simple_bind(tmx.cpu(), data=(2, 3))
    digests = tcache.entry_digests()
    assert len(digests) == 2 and len(set(digests)) == 2
    assert e1._compiled.digest == digests[0]
    assert e1._compiled.canonical
    assert tcache.capacity() == 64
