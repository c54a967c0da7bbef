"""The port's fleet with real replica processes on the CPU, against the JAX
package's single-process decode (the counterpart of ci/check_fleet.py).

A decoder at tests/test_fleet.py's size (vocab 64, d_model 32, 2 layers,
2 heads, d_ff 64, max_len 128; page size 4, 64 pages, max_batch 2) is
built on the JAX package's `init_decoder_params(cfg, seed=0)` carried
through `decoding.params_from_jax`, and saved as a port bundle.
`FleetRouter(bundle, replicas=2, ctx=mx.cpu())` spawns its replicas with
its default command (`python -m mxnet_tpu_torch.fleet.replica ... --ctx
cpu`), each with an empty MXNET_EXEC_CACHE_DIR, as ci/check_fleet.sh
runs them, so a replica restores from the bundle alone.

- Every hello reports 0 traces and 0 compiles, the heal's replacement's
  too.
- One replica is killed by SIGKILL mid-stream; later the replica holding
  the probe request is drained through the admin plane
  (`fleet.cli.admin_call`). Every request completes, and every stream
  equals, token for token, the JAX package's `generate` of the same
  weights in this process (built under its own empty
  MXNET_EXEC_CACHE_DIR with no bundle overlay mounted, so it never
  replays a program another test left in the suite's shared disk root
  or in a bundle).
- The hello, heartbeat and handoff messages carry the JAX package's
  keys.
- Without `--ctx cpu` and with no card, a replica exits non-zero before
  it restores anything.

The stages share one module fixture (a worker that runs several of
them runs them in file order); each checks what it changed, not the
fleet's history.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import contextlib  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import decoding as jdec  # noqa: E402
from mxnet_tpu import exec_cache_disk as jdisk  # noqa: E402
from mxnet_tpu import fleet as jfleet  # noqa: E402
from mxnet_tpu.serving import ModelServer as JaxServer  # noqa: E402
from mxnet_tpu_torch import decoding as tdec  # noqa: E402
from mxnet_tpu_torch import fleet as tfleet  # noqa: E402
from mxnet_tpu_torch import serving as tserving  # noqa: E402
from mxnet_tpu_torch.fleet import cli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
              max_len=128)
MODEL_KW = dict(max_batch=2, page_size=4, num_pages=64,
                page_buckets=(8, 32))
SAMP = {"temperature": 0.8, "top_k": 0, "top_p": 1.0}
MAX_NEW = 100      # long enough that a kill or drain finds the probe live
TIMEOUT = 120


def _prompts():
    # ci/check_fleet.py's: two families sharing multi-page prefixes
    heads = [list(range(2, 18)), list(range(30, 46))]
    return [heads[i % 2] + [50 + i, 51 + i] for i in range(6)]


@contextlib.contextmanager
def _env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _keys(msg):
    return sorted(msg)


@pytest.fixture(scope="module")
def fleet_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    jparams = jdec.init_decoder_params(jdec.DecoderConfig(**CFG_KW), seed=0)
    cfg = tdec.DecoderConfig(**CFG_KW)
    model = tdec.DecodedModel("lm", 1,
                              tdec.params_from_jax(jparams, cfg, "cpu"),
                              cfg, device="cpu", **MODEL_KW)
    try:
        bundle = tserving.save_bundle(model, str(root / "lm.bundle"))
        port_keys = {
            "hello": _keys(tfleet.ReplicaWorker(
                None, model, None, "r0", heartbeat_ms=50,
                hello_extra=tfleet.replica.restore_cost())._hello()),
            "hb": _keys(tfleet.ReplicaWorker(
                None, model, None, "r0", heartbeat_ms=50)._heartbeat(None))}
    finally:
        model.close()
    # the replicas restore from the bundle alone (ci/check_fleet.sh) and
    # run one host thread each beside the suite's workers
    with _env(MXNET_EXEC_CACHE_DIR="", OMP_NUM_THREADS="1"):
        router = tfleet.FleetRouter(bundle, replicas=2, ctx=tmx.cpu(),
                                    name="procs")
        router.start(wait=False)
    try:
        # the reference, while the replicas start: the JAX package's
        # decoder under its own empty disk root, no bundle overlay mounted
        with _env(MXNET_EXEC_CACHE_DIR=str(root / "jax_exec_cache")), \
                pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdisk, "_overlays", [])
            server = JaxServer()
            try:
                ref = server.load_decoder(
                    "ref", jparams, jdec.DecoderConfig(**CFG_KW),
                    **MODEL_KW)
                refs = [ref.generate(p, max_new_tokens=MAX_NEW,
                                     sampling=dict(SAMP, seed=i))
                        for i, p in enumerate(_prompts())]
                jax_keys = {
                    "hello": _keys(jfleet.ReplicaWorker(
                        server, ref, None, "r0", heartbeat_ms=50,
                        hello_extra=jfleet.replica.restore_cost()
                    )._hello()),
                    "hb": _keys(jfleet.ReplicaWorker(
                        server, ref, None, "r0",
                        heartbeat_ms=50)._heartbeat(None))}
                fut = ref.submit(_prompts()[0], max_new_tokens=MAX_NEW,
                                 sampling=dict(SAMP, seed=0))
                next(iter(fut.stream(timeout=TIMEOUT)))
                (states,) = server.drain(timeout=0).values()
                jax_keys["handoff"] = _keys(states[0])
            finally:
                server.stop()
        router.wait_ready(2, timeout=TIMEOUT)
        yield {"router": router, "refs": refs, "jax_keys": jax_keys,
               "port_keys": port_keys, "bundle": bundle,
               "addr": f"127.0.0.1:{router.port}"}
    finally:
        router.stop()


def _probe_replica(router, fut):
    with router._lock:
        pend = router._pending.get(fut.mid)
        return pend.replica_id if pend else None


def _submit_all(router):
    return [router.submit(p, max_new_tokens=MAX_NEW,
                          sampling=dict(SAMP, seed=i))
            for i, p in enumerate(_prompts())]


def test_replicas_restore_with_no_trace_and_no_compile(fleet_case):
    refs = fleet_case["refs"]
    assert len(refs[0]) >= 24, [len(r) for r in refs]
    rows = fleet_case["router"].status()["replicas"]
    assert len(rows) == 2
    assert all((r["traces"], r["compiles"]) == (0, 0)
               for r in rows.values()), rows


def test_sigkill_mid_stream_loses_nothing_and_heals(fleet_case):
    router, refs = fleet_case["router"], fleet_case["refs"]
    before = router.stats.snapshot()
    futs = _submit_all(router)
    stream = futs[0].stream(timeout=TIMEOUT)
    first = [next(stream), next(stream)]
    victim = _probe_replica(router, futs[0])
    os.kill(router.status()["replicas"][victim]["pid"], signal.SIGKILL)
    outs = [first + list(stream)] + [f.result(TIMEOUT) for f in futs[1:]]
    assert all(f.exception() is None for f in futs)
    assert outs == refs
    snap = router.stats.snapshot()
    assert snap["replica_deaths"] == before["replica_deaths"] + 1
    assert snap["readmissions"] > before["readmissions"]
    router.wait_ready(2, timeout=TIMEOUT)
    rows = router.status()["replicas"]
    assert len(rows) == 2 and victim not in rows
    assert all((r["traces"], r["compiles"]) == (0, 0)
               for r in rows.values()), rows


def test_drain_through_the_admin_plane_loses_nothing(fleet_case):
    router, refs = fleet_case["router"], fleet_case["refs"]
    addr = fleet_case["addr"]
    before = router.stats.snapshot()
    n = len(router.status()["replicas"])
    futs = _submit_all(router)
    stream = futs[0].stream(timeout=TIMEOUT)
    first = [next(stream)]
    victim = _probe_replica(router, futs[0])
    out = cli.admin_call(addr, "drain", replica=victim, timeout_ms=0)
    assert out["handoffs"] >= 1
    outs = [first + list(stream)] + [f.result(TIMEOUT) for f in futs[1:]]
    assert all(f.exception() is None for f in futs)
    assert outs == refs
    assert router.stats.snapshot()["handoffs"] > before["handoffs"]
    deadline = time.monotonic() + TIMEOUT
    while victim in router.status()["replicas"] \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    survivors = sorted(cli.admin_call(addr, "status")["replicas"])
    assert len(survivors) == n - 1 and victim not in survivors
    assert router.ledger.snapshot()["drains_escalated"] == 0
    # a drain is no death: no heal
    assert router.stats.snapshot()["replica_deaths"] == \
        before["replica_deaths"]


def test_messages_carry_the_jax_packages_keys(fleet_case):
    jax_keys, port_keys = fleet_case["jax_keys"], fleet_case["port_keys"]
    assert port_keys["hello"] == jax_keys["hello"]
    assert port_keys["hb"] == jax_keys["hb"]
    router = fleet_case["router"]
    rid = sorted(router.status()["replicas"])[0]
    assert _keys(router._handles[rid].hello) == jax_keys["hello"]
    # a beat re-advertises the prefixes only when the digest changed
    assert set(router._handles[rid].hb) <= set(jax_keys["hb"])
    stats = router.replica_stats(rid, timeout=TIMEOUT)
    assert _keys(stats) == jax_keys["hb"]
    handed = []
    server = tserving.ModelServer()
    try:
        cfg = tdec.DecoderConfig(**CFG_KW)
        server.load_decoder("lm", tdec.init_decoder_params(cfg, seed=0),
                            cfg, device="cpu", **MODEL_KW)
        fut = server.submit_decode("lm", _prompts()[0],
                                   max_new_tokens=MAX_NEW,
                                   sampling=dict(SAMP, seed=0))
        next(iter(fut.stream(timeout=TIMEOUT)))
        (handed,) = server.drain(timeout=0).values()
    finally:
        server.stop()
    assert _keys(handed[0]) == jax_keys["handoff"]


def test_stop_reaps_every_replica(fleet_case):
    router = fleet_case["router"]
    with router._lock:
        procs = list(router._procs.values())
    router.stop()
    assert procs and all(p.poll() is not None for p in procs)
    assert router.status()["replicas"] == {}


def test_replica_without_a_card_exits_before_restoring(tmp_path):
    cmd = tfleet.router.replica_command(str(tmp_path / "missing.bundle"),
                                        9, "r0", 200, tmx.gpu())
    assert cmd[1:3] == ["-m", "mxnet_tpu_torch.fleet.replica"]
    assert cmd[-2:] == ["--ctx", "gpu:0"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode != 0
    if not torch.cuda.is_available():
        assert "no CUDA device is available" in proc.stderr
        assert "missing.bundle" not in proc.stderr   # before the restore
    assert tfleet.replica.parse_ctx("cpu") == tmx.cpu()
    assert tfleet.replica.parse_ctx("gpu:1") == tmx.gpu(1)
    with pytest.raises(ValueError):
        tfleet.replica.parse_ctx("tpu")
    assert sys.executable == cmd[0]
