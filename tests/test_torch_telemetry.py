"""The port's telemetry (mxnet_tpu_torch/telemetry: registry, trace,
http, flight) and profiler against the JAX package's, on the CPU.

- tests/test_telemetry.py replayed on the port (the reference source
  with the module name `mxnet_tpu` read as `mxnet_tpu_torch`, the
  metric names kept, under `with mx.cpu():`,
  after the reference file's fixture): the instruments and views, the
  span ring, the serving request traced submit -> reply, the latency
  histogram, fit's step spans, the exporter over localhost, the flight
  recorder (the excepthook case in a child interpreter, and the
  FaultInjector's dumps on an injected step and epoch fault).
- The same sequence of instrument calls and views gives byte-identical
  Prometheus text in both packages, and the default registries carry
  the same native metric names (the serving latency histogram and the
  decode tier's instruments, which dashboards read).
- `dump_profile`'s keys come in the JAX package's order, and with
  MXNET_TPU_XLA_TRACE_DIR the torch.profiler capture merges in at pid
  >= 1000 beside the executor events.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import inspect  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import telemetry as jtel  # noqa: E402
from mxnet_tpu_torch import profiler as tprof  # noqa: E402
from mxnet_tpu_torch import serving as tserving  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.telemetry import registry as treg  # noqa: E402
from mxnet_tpu_torch.telemetry import trace as ttrace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# reference test -> the ROADMAP.md item that holds it back (none now)
NOT_REPLAYED = {}
def _replay(test_file):
    path = ROOT / "tests" / test_file
    # module names only: the metric names (mxnet_tpu_*) stay as they are
    src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", path.read_text())
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


TELEMETRY = _replay("test_telemetry.py")
ALL_TESTS = sorted(n for n in TELEMETRY if n.startswith("test_"))
TELEMETRY_TESTS = [n for n in ALL_TESTS if n not in NOT_REPLAYED]


@pytest.fixture(autouse=True)
def _fresh():
    ttrace.clear()
    tserving.stats._registry.clear()
    yield
    ttel.stop_exporter()


def test_every_reference_telemetry_test_is_accounted_for():
    assert set(NOT_REPLAYED) <= set(ALL_TESTS)
    assert len(ALL_TESTS) == 23, ALL_TESTS
    assert len(TELEMETRY_TESTS) == 23


@pytest.mark.parametrize("name", TELEMETRY_TESTS)
def test_telemetry_replayed(name, tmp_path, monkeypatch):
    fn = TELEMETRY[name]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path),
                                ("monkeypatch", monkeypatch))
              if k in params}
    with tmx.cpu():
        fn(**kwargs)


# ------------------------------------------------------------- helpers
def _fixed_net():
    return tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                                  name="fc")


# ------------------------------------------------ parity with the JAX one
def _drive(treg_mod):
    reg = treg_mod.MetricsRegistry()
    c = reg.counter("mxnet_tpu_x_total", "x")
    c.inc()
    c.inc(3, model="a:1", phase="decode")
    c.inc(model='we"ird\nname')
    g = reg.gauge("mxnet_tpu_depth", "depth")
    g.set(4, model="b")
    g.set(2.5)
    reg.gauge("mxnet_tpu_live").set_fn(lambda: 17)
    h = reg.histogram("mxnet_tpu_lat_ms", "lat", buckets=(1, 2.5, 10))
    for v in (0.2, 1.0, 3.0, 3.5, 11.0, 1e9):
        h.observe(v, model="m:1")
    h.observe(0.7)
    reg.register_view("execCacheStats", lambda: {"hits": 2, "enabled": True,
                                                 "none": None},
                      prom_prefix="exec_cache")
    reg.register_view("graphPassStats",
                      lambda: {"folds": 3, "pass_time_us": {"dce": 1.5,
                                                            "cse": 2}},
                      prom_prefix="graph_passes")
    reg.register_view("servingStats",
                      lambda: {"m:1": {"qps": 2.5, "p99_ms": 8.0,
                                       "traces_since_warmup": None},
                               "a-b:2": {"completed": 7}},
                      prom_prefix="serving", omit_empty=True,
                      label_name="model")
    reg.register_view("weird key!", lambda: {"9lives": 1})
    reg.register_view("broken", lambda: 1 / 0)
    return reg


def test_prometheus_text_byte_identical():
    from mxnet_tpu.telemetry import registry as jreg

    jr, tr = _drive(jreg), _drive(treg)
    assert tr.prometheus_text().encode() == jr.prometheus_text().encode()
    assert tr.metrics_snapshot() == jr.metrics_snapshot()
    assert tr.view_items() == jr.view_items()


def test_default_registry_metric_names_equal():
    """Importing the serving and decode tiers registers the same native
    metrics, under the same names, in both packages."""
    import mxnet_tpu.decoding.stats  # noqa: F401
    import mxnet_tpu.serving.server  # noqa: F401
    import mxnet_tpu_torch.decoding.stats  # noqa: F401
    import mxnet_tpu_torch.serving.server  # noqa: F401

    def kinds(reg):
        with reg._lock:
            return {n: (m.kind, m.help, getattr(m, "bounds", None))
                    for n, m in reg._metrics.items()
                    if n.startswith(("mxnet_tpu_serving", "mxnet_tpu_decode"))}

    want = kinds(jtel.REGISTRY)
    assert want and kinds(ttel.REGISTRY) == want


def test_span_and_stat_surface_equal():
    assert sorted(ttel.bench_snapshot()) == sorted(jtel.bench_snapshot())
    assert sorted(tprof.host_sync_stats()) == \
        sorted(jmx.profiler.host_sync_stats())
    names = [n for n in dir(jtel) if not n.startswith("_")]
    assert [n for n in names if not hasattr(ttel, n)] == []


def test_host_sync_counted_at_the_reference_sites():
    tprof.reset_host_sync_stats()
    a = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    a.asnumpy()
    a.wait_to_read()
    metric = tmx.metric.Accuracy()
    metric.update([tmx.nd.array(np.array([0, 1], np.float32),
                                ctx=tmx.cpu())],
                  [tmx.nd.array(np.array([[1, 0], [0, 1]], np.float32),
                                ctx=tmx.cpu())])
    metric.get()
    s = tprof.host_sync_stats()
    assert s["blocking_waits"] == 1
    assert s["metric_fetches"] <= 1
    assert s["blocking_fetches"] >= 1 + s["metric_fetches"]


def test_capture_merges_above_pid_1000(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_XLA_TRACE_DIR", str(tmp_path / "cap"))
    fn = str(tmp_path / "p.json")
    tprof.profiler_set_config(filename=fn)
    tprof.profiler_set_state("run")
    ex = _fixed_net().simple_bind(ctx=tmx.cpu(), data=(2, 8))
    ex.forward(data=np.ones((2, 8), np.float32))
    tprof.profiler_set_state("stop")
    with open(fn) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    host = [e for e in events if e.get("cat") == "executor"]
    device = [e for e in events if e["pid"] >= 1000]
    assert [e["ph"] for e in host] == ["B", "E"]
    assert device and all(isinstance(e["pid"], int) for e in events)
    ops = [e for e in device if e.get("ph") == "X"]
    assert any("addmm" in e["name"] or "linear" in e["name"] for e in ops)
    # re-based onto the host clock: the capture's slices sit around the
    # executor's event, not at torch.profiler's own origin
    t0 = min(e["ts"] for e in ops)
    assert abs(t0 - host[0]["ts"]) < 5e6
    assert list(trace)[:3] == ["traceEvents", "displayTimeUnit",
                               "execCacheStats"]
