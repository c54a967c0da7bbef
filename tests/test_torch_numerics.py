"""The port's run health (mxnet_tpu_torch/numerics: the sentinel row in
the fused step, the anomaly rules, first-bad-op attribution, the run log
and the numericsStats view) against the JAX package's, on the CPU.

- The sentinel: the same numpy-seeded weights and batches through both
  packages' fused steps with the sentinel on give rows whose columns
  have the same names in the same order and whose values agree within
  1e-5 relative (1e-6 absolute for the counts and the norms near 0);
  the decoded rows (norms, ratios) too.
- The rules and the run log: a fit with MXNET_TPU_FAULT_INJECT=nan:step:2
  over both packages (rows drained at the epoch's end) gives the same
  anomalies (kind, step, group) and a run log with the same events in
  the same order (the values of each step event within 1e-5), the same
  first bad op, and the JAX package's `read_events` reads the port's
  log.
- numericsStats's Prometheus text is the JAX package's, byte for byte,
  after the same rows and anomalies.
- tests/test_numerics.py replayed on the port (the reference source with
  the module name `mxnet_tpu` read as `mxnet_tpu_torch`, under `with
  mx.cpu():`). REWRITTEN: the two sentinel-oracle tests hand
  SentinelSpec.compute jax arrays, here torch tensors; the two decode
  guard tests build their DecodedModel on the CPU by name. NOT_REPLAYED:
  the cases that wait for another ROADMAP.md item.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import inspect  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu.numerics import stats as jstats  # noqa: E402
from mxnet_tpu.numerics.runlog import read_events as jread  # noqa: E402
from mxnet_tpu.telemetry import registry as jreg  # noqa: E402
from mxnet_tpu_torch.module.module import params_from_jax  # noqa: E402
from mxnet_tpu_torch.numerics import SentinelSpec  # noqa: E402
from mxnet_tpu_torch.numerics import stats as tstats  # noqa: E402
from mxnet_tpu_torch.telemetry import registry as treg  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5

NOT_REPLAYED = {}
REWRITTEN = {
    "test_sentinel_compute_matches_numpy_oracle":
        "SentinelSpec.compute takes torch tensors",
    "test_sentinel_counts_nonfinite":
        "SentinelSpec.compute takes torch tensors",
    "test_decode_guard_counts_nonfinite_logits":
        "the DecodedModel runs on the card unless told the CPU",
    "test_decode_guard_off_by_default":
        "the DecodedModel runs on the card unless told the CPU",
}
_ENV = ("MXNET_NUMERICS", "MXNET_NUMERICS_INTERVAL",
        "MXNET_NUMERICS_HISTORY", "MXNET_NUMERICS_RUNLOG",
        "MXNET_NUMERICS_SPIKE", "MXNET_NUMERICS_ATTRIBUTION",
        "MXNET_NUMERICS_DECODE_GUARD", "MXNET_TPU_FAULT_INJECT",
        "MXNET_TELEMETRY_FLIGHT_DIR", "MXNET_TPU_OPT_STATE_DTYPE")


def _replay(test_file):
    path = ROOT / "tests" / test_file
    src = re.sub(r"\bmxnet_tpu\b(?!/)", "mxnet_tpu_torch", path.read_text())
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


NUMERICS = _replay("test_numerics.py")
REPLAYED = sorted(n for n in NUMERICS if n.startswith("test_")
                  and n not in NOT_REPLAYED and n not in REWRITTEN)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    tstats.reset_numerics_stats()
    jstats.reset_numerics_stats()
    yield


@pytest.mark.parametrize("name", REPLAYED)
def test_replayed(name, tmp_path, monkeypatch):
    fn = NUMERICS[name]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path),
                                ("monkeypatch", monkeypatch))
              if k in params}
    with tmx.cpu():
        fn(**kwargs)


def test_lists_name_reference_tests():
    for name in list(NOT_REPLAYED) + list(REWRITTEN):
        assert name in NUMERICS, name


# ------------------------------------------------------ rewritten cases
def _oracle(seed=5):
    names = ("fc1_weight", "fc1_bias", "fc2_weight")
    rs = np.random.RandomState(seed)
    params = {n: rs.randn(4, 3).astype(np.float32) for n in names}
    grads = {n: rs.randn(4, 3).astype(np.float32) for n in names}
    outs = [rs.randn(6, 2).astype(np.float32),
            rs.randn(3).astype(np.float32)]
    return names, params, grads, outs


def _compute(spec, outs, params, new_params, grads):
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    row = spec.compute([torch.from_numpy(o) for o in outs], t(params),
                       t(new_params), t(grads))
    assert row.dtype == torch.float32 and row.shape == (spec.width,)
    return spec.decode_row(row.numpy())


def test_sentinel_compute_matches_numpy_oracle():
    names, params, grads, outs = _oracle()
    spec = SentinelSpec(names)
    assert spec.columns[:2] == ("loss", "out_nonfinite")
    assert spec.groups["fc1"] == ("fc1_weight", "fc1_bias")
    new_params = {n: params[n] - 0.1 * grads[n] for n in names}
    d = _compute(spec, outs, params, new_params, grads)
    approx = lambda v: pytest.approx(v, rel=1e-5, abs=1e-6)  # noqa: E731
    assert d["loss"] == approx(float(outs[0].mean()))
    assert d["out_nonfinite"] == 0.0
    for g, members in spec.groups.items():
        seg = d["groups"][g]
        gsq = sum(float((grads[n] ** 2).sum()) for n in members)
        psq = sum(float((params[n] ** 2).sum()) for n in members)
        usq = sum(float(((new_params[n] - params[n]) ** 2).sum())
                  for n in members)
        assert seg["grad_norm"] == approx(math.sqrt(gsq))
        assert seg["param_norm"] == approx(math.sqrt(psq))
        assert seg["update_norm"] == approx(math.sqrt(usq))
        assert seg["grad_max_abs"] == approx(
            max(float(np.abs(grads[n]).max()) for n in members))
    gsq = sum(float((grads[n] ** 2).sum()) for n in names)
    assert d["grad_norm"] == approx(math.sqrt(gsq))
    assert d["update_ratio"] == approx(d["update_norm"] / d["param_norm"])


def test_sentinel_counts_nonfinite():
    names, params, grads, outs = _oracle()
    spec = SentinelSpec(names)
    grads["fc1_weight"][0, 0] = np.nan
    grads["fc1_weight"][0, 1] = np.inf
    params["fc2_weight"][1, 1] = np.inf
    outs[0][0, 0] = np.nan
    new_params = {n: params[n] - 0.1 * grads[n] for n in names}
    d = _compute(spec, outs, params, new_params, grads)
    assert d["out_nonfinite"] == 1.0
    assert d["groups"]["fc1"]["grad_nonfinite"] == 2.0
    assert d["groups"]["fc2"]["param_nonfinite"] == 1.0
    assert d["grad_nonfinite"] == 2.0 and d["param_nonfinite"] == 1.0
    assert not math.isfinite(d["loss"])


def _decoder(monkeypatch, guard, poison):
    from mxnet_tpu_torch import decoding as dec

    if guard:
        monkeypatch.setenv("MXNET_NUMERICS_DECODE_GUARD", "1")
    cfg = dec.DecoderConfig(vocab=32, d_model=16, n_layers=2, n_heads=2,
                            d_ff=32, max_len=64)
    params = dict(dec.init_decoder_params(cfg, seed=0))
    if poison:
        params["ln_f"] = np.asarray(params["ln_f"]) * np.nan
    return dec.DecodedModel("lm_guard", 1, params, cfg, max_batch=2,
                            page_size=4, num_pages=32,
                            page_buckets=(1, 2, 4), max_tokens=8,
                            device="cpu")


def test_decode_guard_counts_nonfinite_logits(monkeypatch):
    m = _decoder(monkeypatch, True, True)
    try:
        assert m.engine._guard
        m.generate([5, 6, 7], max_new_tokens=4, timeout=60)
        total = sum(nf for nf, _ in m.engine.drain_guard()) \
            + m.stats.snapshot()["nonfinite_logits"]
        assert total > 0
    finally:
        m.close()


def test_decode_guard_off_by_default(monkeypatch):
    m = _decoder(monkeypatch, False, False)
    try:
        assert not m.engine._guard
        m.generate([5, 6, 7], max_new_tokens=2, timeout=60)
        assert m.engine.drain_guard() == []
        assert m.stats.snapshot()["nonfinite_logits"] == 0
    finally:
        m.close()


# -------------------------------------------------------------- parity
def _mlp(mx):
    d = mx.sym.Variable("data")
    f1 = mx.sym.FullyConnected(d, name="fc1", num_hidden=16)
    a1 = mx.sym.Activation(f1, name="relu1", act_type="relu")
    f2 = mx.sym.FullyConnected(a1, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(f2, name="softmax")


def _data(n=96):
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (n, 8)).astype(np.float32)
    y = rs.randint(0, 4, (n,)).astype(np.float32)
    return x, y


def _init():
    with jmx.cpu():
        mod = jmx.mod.Module(_mlp(jmx), context=jmx.cpu())
        mod.bind(data_shapes=[("data", (32, 8))],
                 label_shapes=[("softmax_label", (32,))])
        jmx.random.seed(7)
        mod.init_params(jmx.initializer.Uniform(0.3))
        return mod.get_params()


def _fit(mx, init, mon_kwargs, epochs=2):
    """A fit with a NumericsMonitor over both packages from one init."""
    x, y = _data()
    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=32)
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        args, auxs = init if mx is jmx else params_from_jax(
            *init, ctx=tmx.cpu())
        mon = mx.numerics.NumericsMonitor(**mon_kwargs)
        mod.fit(it, num_epoch=epochs, numerics=mon, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
                arg_params=args, aux_params=auxs)
    return mod, mon


def _row_close(a, b, what):
    for k, v in a.items():
        if k == "groups":
            for g, seg in v.items():
                _row_close(seg, b[k][g], f"{what}/{g}")
        elif isinstance(v, float) and math.isfinite(v):
            assert b[k] == pytest.approx(v, rel=TOL, abs=1e-6), (what, k)
        else:
            assert (b[k] == v) or (isinstance(v, float) and math.isnan(v)
                                   and math.isnan(b[k])), (what, k)


def test_sentinel_rows_match_jax():
    init = _init()
    _, jmon = _fit(jmx, init, {"interval": 2})
    tmod, tmon = _fit(tmx, init, {"interval": 2})
    assert tmod._fused_step._sentinel.columns == \
        SentinelSpec(tmod._fused_step._trainable).columns
    from mxnet_tpu.numerics import SentinelSpec as JSpec

    assert tmod._fused_step._sentinel.columns == JSpec(
        tmod._fused_step._trainable).columns
    jrows, trows = list(jmon.history), list(tmon.history)
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] \
        == list(range(1, 7))
    for j, t in zip(jrows, trows):
        _row_close(j, t, f"step {j['step']}")


def test_anomalies_and_run_log_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FAULT_INJECT", "nan:step:2:fc1_weight")
    init = _init()
    logs = {}
    mons = {}
    for mx in (jmx, tmx):
        path = str(tmp_path / f"{mx.__name__}.jsonl")
        monkeypatch.setenv("MXNET_TELEMETRY_FLIGHT_DIR",
                           str(tmp_path / f"flight-{mx.__name__}"))
        # interval 0: the rows drain at the epoch's end, in one fetch,
        # so the events' order does not hang on when a row was ready
        _, mons[mx] = _fit(mx, init, {"interval": 0, "run_log": path},
                           epochs=1)
        logs[mx] = jread(path)   # the JAX package's reader for both
    key = lambda a: (a.kind, a.step, a.group)  # noqa: E731
    assert [key(a) for a in mons[tmx].anomalies] == \
        [key(a) for a in mons[jmx].anomalies]
    assert mons[tmx].anomalies and mons[tmx].anomalies[0].step == 2
    jev, tev = logs[jmx], logs[tmx]
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    for j, t in zip(jev, tev):
        if j["event"] == "step":
            assert t["step"] == j["step"]
            for k in ("loss", "grad_norm", "param_norm", "update_ratio",
                      "lr"):
                if math.isfinite(j[k]):
                    assert t[k] == pytest.approx(j[k], rel=TOL, abs=1e-6)
        elif j["event"] == "anomaly":
            assert (t["kind"], t["step"], t.get("first_bad_op")) == \
                (j["kind"], j["step"], j.get("first_bad_op"))
    assert [e for e in tev if e["event"] == "anomaly"][0][
        "first_bad_op"] == "fc1_output"


def test_numerics_prometheus_text_is_the_jax_packages():
    from mxnet_tpu.numerics.rules import NumericsAnomaly as JA

    from mxnet_tpu_torch.numerics.rules import NumericsAnomaly as TA

    row = {"loss": 0.5, "grad_norm": 1.25, "param_norm": 3.0,
           "update_ratio": 0.01, "out_nonfinite": 0.0,
           "grad_nonfinite": 0.0, "param_nonfinite": 0.0}
    texts = []
    for reg, st, anom in ((jreg, jstats, JA), (treg, tstats, TA)):
        st.note_row(3, row, lr=0.1)
        st.note_anomaly(anom(kind="grad_spike", step=3, message="m"))
        text = reg.REGISTRY.prometheus_text()
        # the anomaly counter's samples count every anomaly this process
        # saw in either package (other tests too): its help and type
        # lines are compared, the gauges and the view's series in full
        texts.append("\n".join(
            line for line in text.splitlines() if "numerics" in line
            and not line.startswith("mxnet_tpu_numerics_anomalies_total{")))
    assert "mxnet_tpu_numerics_grad_norm 1.25" in texts[1]
    assert texts[0] == texts[1]
    assert tstats.numerics_stats() == jstats.numerics_stats()


def test_run_log_is_read_by_either_package(tmp_path):
    from mxnet_tpu_torch.numerics import RunEventLog, read_events

    path = str(tmp_path / "run.jsonl")
    log = RunEventLog(path).open()
    log.step(1, {"loss": 0.5, "grad_norm": 1.0}, lr=0.1)
    log.epoch(0, {"accuracy": 0.5})
    log.close()
    assert read_events(path) == jread(path)
    assert [e["event"] for e in jread(path)] == ["start", "step", "epoch"]
    assert json.loads(open(path).read().splitlines()[1])["step"] == 1
