"""The port's fault tolerance (mxnet_tpu_torch/fault.py) against the JAX
package's, on the CPU.

- tests/test_fault.py replayed on the port (the reference source with the
  module name `mxnet_tpu` read as `mxnet_tpu_torch`, under `with
  mx.cpu():`): crash at an injected epoch and resume, the no-op resume of
  a finished run, the spec read from MXNET_TPU_FAULT_INJECT, the refusal
  of 'kill:epoch:N', and 'kill:step:N' taking its child down by SIGKILL
  with no finally, atexit or exception unwind (the child imports only
  `mxnet_tpu_torch.fault`).
- Across packages: a JAX package Module running `fit_auto_resume` over a
  seeded data pipeline is stopped by FaultInjector("step:9") in its
  second epoch. The port resumes it from its checkpoint and data-state
  file: the batches of the killed run and of the port's resume are,
  byte for byte, the JAX package's uninterrupted run's, and the port's
  final parameters equal the JAX package's own resume of the same files
  within 1e-5 of each tensor's largest magnitude (at least 1), the
  tolerance of tests/test_torch_fused_step.py's SGD cases. Parameters
  are durable per epoch in both packages (the checkpoint format they
  share), so a resumed run restarts the killed epoch's parameters from
  its start while its data resumes at the kill: the JAX package's
  uninterrupted run's parameters are not the resumed runs' in either
  package, and the test holds the port to the JAX package's resume.
- `dp_step.parse_nan_inject`, the name the numerics fault was parsed
  under before fault.py was ported, still parses it.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import inspect  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import data as jdata  # noqa: E402
from mxnet_tpu import fault as jfault  # noqa: E402
from mxnet_tpu_torch import data as tdata  # noqa: E402
from mxnet_tpu_torch import fault as tfault  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


def _replay(test_file):
    path = ROOT / "tests" / test_file
    src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", path.read_text())
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


FAULT = _replay("test_fault.py")
FAULT_TESTS = sorted(n for n in FAULT if n.startswith("test_"))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_FAULT_INJECT", raising=False)
    monkeypatch.delenv("MXNET_NUMERICS", raising=False)
    yield


def test_every_reference_fault_test_is_replayed():
    assert len(FAULT_TESTS) == 5, FAULT_TESTS


@pytest.mark.parametrize("name", FAULT_TESTS)
def test_fault_replayed(name, tmp_path, monkeypatch):
    fn = FAULT[name]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path),
                                ("monkeypatch", monkeypatch))
              if k in params}
    with tmx.cpu():
        fn(**kwargs)


# ------------------------------------------------- across the packages
def _mlp(mx):
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                              name="fc"), name="softmax")


class _Recording:
    """The data iterator, logging the bytes of every batch fit takes."""

    def __init__(self, inner, log):
        self._inner, self._log = inner, log

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        b = self._inner.next()
        self._log.append(b.data[0].asnumpy().tobytes())
        return b


def _fit(mx, data, fault, prefix, log, spec=""):
    """fit_auto_resume of `mx`'s Module over 48 seeded rows, 6 batches an
    epoch, 2 epochs; returns its final parameters as numpy."""
    rs = np.random.RandomState(0)
    x = rs.rand(48, 10).astype(np.float32)
    y = (x.sum(axis=1) > 5).astype(np.float32)
    with mx.cpu():
        mx.random.seed(3)
        it = _Recording(data.make_pipeline(x, 8, label=y, seed=11,
                                           shard_id=0, num_shards=1), log)
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        try:
            fault.fit_auto_resume(
                mod, it, prefix, num_epoch=2,
                fault_injector=fault.FaultInjector(spec),
                optimizer="sgd", optimizer_params={"learning_rate": 0.5})
        finally:
            it._inner.close()
        arg, aux = mod.get_params()
        return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


def test_port_resumes_a_run_the_jax_package_lost(tmp_path):
    prefix = str(tmp_path / "job" / "run")
    os.makedirs(os.path.dirname(prefix))
    killed = []
    with pytest.raises(RuntimeError, match="fault-injection"):
        _fit(jmx, jdata, jfault, prefix, killed, "step:9")
    assert len(killed) == 9
    state = tdata.read_state(tfault.data_state_path(prefix))
    assert state["epoch"] == 1 and state["position"] == 3
    assert tfault.latest_checkpoint(prefix) == 1
    # the JAX package's own resume reads a copy of the same files
    jcopy = str(tmp_path / "jcopy")
    shutil.copytree(os.path.dirname(prefix), jcopy)

    resumed = []
    got = _fit(tmx, tdata, tfault, prefix, resumed)
    assert tfault.latest_checkpoint(prefix) == 2
    uninterrupted = []
    _fit(jmx, jdata, jfault, str(tmp_path / "ref"), uninterrupted)
    assert killed + resumed == uninterrupted
    want = _fit(jmx, jdata, jfault, os.path.join(jcopy, "run"), [])
    assert sorted(got) == sorted(want)
    for name in want:
        scale = max(float(np.abs(want[name]).max()), 1.0)
        assert np.abs(got[name] - want[name]).max() <= TOL * scale, name


def test_dp_step_parse_nan_inject_is_fault_s(monkeypatch):
    from mxnet_tpu_torch.parallel import dp_step

    assert dp_step.parse_nan_inject("nan:step:4:fc_weight") == \
        tfault.parse_nan_inject("nan:step:4:fc_weight") == (4, "fc_weight")
    monkeypatch.setenv("MXNET_TPU_FAULT_INJECT", "nan:step:2")
    assert dp_step.parse_nan_inject() == jfault.parse_nan_inject() == (2, None)
    assert tfault.parse_nan_inject("step:2") is None
    with pytest.raises(tmx.MXNetError, match="integer"):
        tfault.parse_nan_inject("nan:step:x")
