"""The fleet control plane of the port (`mxnet_tpu_torch.fleet`) against
the JAX package's (`mxnet_tpu.fleet`), on the CPU.

- tests/test_fleet.py's 19 tests replayed on the port: the reference
  test source with the module name `mxnet_tpu` read as `mxnet_tpu_torch`
  (the metric names keep their `mxnet_tpu_` prefix), its `import
  mx_fleet` read as the port's CLI module (`mxnet_tpu_torch.fleet.cli`),
  run under `with mx.cpu():`, and its ModelServer's decoders given
  device="cpu" (the port's default is the card, and the fleet's replica
  threads do not inherit the test's context). The three cases the
  reference marks slow (its tiny decoder's warmup) are not slow here:
  the port's warms in about 0.1 s, so they run unmarked.
- Parity with the JAX package:
  * the bytes `send_frame` writes for the same objects;
  * both routers driven by the same script of fake replicas (manual
    heartbeats, a drain, a death mid-stream and its heal) make the same
    routing decisions, relay the same tokens and end with equal
    `stats.snapshot()`, `status()` (but its name and port) and drain
    ledgers, under each policy;
  * `AffinityIndex.best`, `Autoscaler.observe` sequences and
    `DrainLedger` snapshots on seeded inputs;
  * a replica's error frame, and a port decoder's handoff state passes
    the JAX package's `check_handoff_state`;
  * the six MXNET_FLEET_* knobs (types, defaults, help), the
    instruments' names and help, `mx.fleet.__all__`.
- A served model behind an in-process replica answers `router.predict`
  bit for bit as its own `infer` does, after the float32 round trip
  through JSON.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import ast  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import socket  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import fleet as jfleet  # noqa: E402
from mxnet_tpu import utils as jutils  # noqa: E402
from mxnet_tpu.decoding.prefix import page_digests as jdigests  # noqa: E402
from mxnet_tpu.fleet import stats as jstats  # noqa: E402
from mxnet_tpu_torch import decoding as tdec  # noqa: E402
from mxnet_tpu_torch import fleet as tfleet  # noqa: E402
from mxnet_tpu_torch import serving as tserving  # noqa: E402
from mxnet_tpu_torch import utils as tutils  # noqa: E402
from mxnet_tpu_torch.decoding.prefix import page_digests as tdigests  # noqa: E402,E501
from mxnet_tpu_torch.fleet import stats as tstats  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"jax": (jfleet, jdigests), "port": (tfleet, tdigests)}
FLEET_KNOBS = ("MXNET_FLEET_REPLICAS", "MXNET_FLEET_PORT",
               "MXNET_FLEET_HEARTBEAT_MS", "MXNET_FLEET_QUEUE_HIGH",
               "MXNET_FLEET_QUEUE_LOW", "MXNET_FLEET_DRAIN_TIMEOUT_MS")


@pytest.fixture(autouse=True)
def _no_fleet_knobs(monkeypatch):
    for var in FLEET_KNOBS:
        monkeypatch.delenv(var, raising=False)


# ------------------------------------------ tests/test_fleet.py, replayed
class _ImportCli(ast.NodeTransformer):
    """`import mx_fleet` (tools/mx_fleet.py) -> the port's CLI module."""

    def visit_Import(self, node):
        if [a.name for a in node.names] == ["mx_fleet"]:
            return ast.parse(
                "from mxnet_tpu.fleet import cli as mx_fleet").body[0]
        return node


def _replay_fleet():
    """tests/test_fleet.py's namespace on the port. Its module fixture
    `tiny` loses its decorator (this file's `tiny` fixture runs it)."""
    path = ROOT / "tests" / "test_fleet.py"
    tree = _ImportCli().visit(ast.parse(path.read_text()))
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "tiny":
            node.decorator_list = []
            node.name = "_tiny"
    src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", ast.unparse(tree))
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)

    class HostServer(tserving.ModelServer):
        """The reference's ModelServer: decoders on the host."""

        def load_decoder(self, name, params, decoder_cfg, **kwargs):
            kwargs.setdefault("device", "cpu")
            return super().load_decoder(name, params, decoder_cfg,
                                        **kwargs)

    ns["ModelServer"] = HostServer
    return ns


FLEET = _replay_fleet()
FLEET_TESTS = sorted(n for n in FLEET if n.startswith("test_"))


@pytest.fixture(scope="module")
def tiny():
    yield from FLEET["_tiny"]()


def test_every_reference_case_replayed():
    tree = ast.parse((ROOT / "tests" / "test_fleet.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert len(names) == 19 and sorted(names) == FLEET_TESTS
    slow = [n for n in FLEET_TESTS
            if any(m.name == "slow"
                   for m in getattr(FLEET[n], "pytestmark", []))]
    assert slow == ["test_drain_handoff_resumes_bit_identical",
                    "test_drain_idle_and_strand_fix",
                    "test_fleet_end_to_end_drain_over_wire"]


@pytest.mark.parametrize("name", FLEET_TESTS)
def test_fleet_replayed(name, request):
    fn = FLEET[name]
    kwargs = {k: request.getfixturevalue(k)
              for k in inspect.signature(fn).parameters}
    with tmx.cpu():
        fn(**kwargs)


# ------------------------------------------------------------- wire bytes
FRAMES = [
    {}, [], {"op": "hello", "id": "r0", "pid": 0, "model": "lm"},
    {"s": "héllo wörld — ✓ 中文 \U0001f600", "esc": "a\"b\\c\n\t\x01"},
    {"nested": [[1, [2, [3, []]]], {"a": {"b": [None, True, False]}}]},
    {"f": [0.1, -2.5e-08, 1e300, 3.0, -0.0, 123456789.125]},
    {"i": [0, -1, 2 ** 40, -(2 ** 53)], "t": [31999, 7]},
    {"id": "m7", "handoff": {"prompt": [1, 2], "generated": [3],
                             "max_new_tokens": 8, "priority": 0,
                             "sampling": {"temperature": 0.8, "top_k": 40,
                                          "top_p": 0.95, "seed": 2300}}},
]


def _wire_bytes(fleet, obj):
    a, b = socket.socketpair()
    try:
        fleet.send_frame(a, obj)
        a.shutdown(socket.SHUT_WR)
        out = bytearray()
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return bytes(out)
            out.extend(chunk)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_send_frame_bytes_match_the_jax_package(i):
    obj = FRAMES[i]
    got, want = _wire_bytes(tfleet, obj), _wire_bytes(jfleet, obj)
    assert got == want
    assert int.from_bytes(got[:4], "big") == len(got) - 4
    a, b = socket.socketpair()
    try:
        a.sendall(want)
        assert tfleet.recv_frame(b) == json.loads(want[4:].decode())
    finally:
        a.close()
        b.close()
    assert tfleet.MAX_FRAME == jfleet.MAX_FRAME == 64 << 20


# ---------------------------------------------- routers, one fake script
def _tok(prompt, p):
    return (sum(prompt) + 7 * p + 3) % 97


class _Fake:
    """A replica that speaks the wire protocol through `fleet`'s Channel
    and heartbeats only when told (so a script is deterministic). A
    request whose prompt starts with HOLD stops after two tokens until
    the fake is killed."""

    HOLD = 90

    def __init__(self, fleet, rid, port):
        self.rid = rid
        self.seen = []
        self._stop = threading.Event()
        self.chan = fleet.Channel(
            socket.create_connection(("127.0.0.1", port)), name=rid)
        self.chan.send({"op": "hello", "id": rid, "pid": 0,
                        "model": "fake", "version": 1, "kind": "decoded",
                        "page_size": 4, "kv_dtype": "float32",
                        "traces": 0, "compiles": 0})
        threading.Thread(target=self._loop, daemon=True).start()

    def hb(self, depth=0, prefixes=None):
        msg = {"op": "hb", "id": self.rid, "draining": False,
               "depth": depth, "digest": f"d{depth}",
               "stats": {"prefix_hit_rate": 0.25, "kv_occupancy": 0.5,
                         "pages_allocated": depth}}
        if prefixes is not None:
            msg["prefixes"] = prefixes
        self.chan.send(msg)
        return msg

    def _loop(self):
        while True:
            msg = self.chan.recv()
            if msg is None or self._stop.is_set():
                return
            self.seen.append(msg)
            op = msg.get("op")
            if op in ("generate", "resume"):
                threading.Thread(target=self._serve, args=(msg,),
                                 daemon=True).start()
            elif op == "drain":
                self.chan.send({"id": msg["id"], "done": {"handoffs": 0}})
                self.chan.flush(timeout=5)
                self.kill()
                return
            elif op == "stop":
                self.kill()
                return

    def _serve(self, msg):
        if msg["op"] == "generate":
            prompt, start, n = msg["prompt"], 0, msg["max_new_tokens"]
        else:
            st = msg["state"]
            prompt, start = st["prompt"], len(st["generated"])
            n = st["max_new_tokens"]
        for p in range(start, n):
            if prompt[0] == self.HOLD and p >= 2 and \
                    msg["op"] == "generate":
                self._stop.wait()
            if self._stop.is_set():
                return
            self.chan.send({"id": msg["id"], "tok": _tok(prompt, p)})
        self.chan.send({"id": msg["id"], "done": {"reason": "max_tokens"}})

    def kill(self):
        self._stop.set()
        self.chan.close()


def _wait(pred, timeout=20, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _where(fakes, mid):
    return [rid for rid, f in sorted(fakes.items())
            for m in f.seen if m.get("id") == mid
            and m.get("op") in ("generate", "resume")]


def _router_script(pkg, policy):
    """One script, run on either package's router: returns what it
    decided, relayed and reported."""
    fleet, digests = PACKAGES[pkg]
    fakes, box = {}, {}

    def spawn(rid, port):
        fakes[rid] = _Fake(fleet, rid, port)
        # replicas register one at a time: the handle order (which the
        # random policy and the least-loaded tie-break read) is fixed
        _wait(lambda: rid in box["router"]._handles, what=f"{rid} hello")
        return None

    router = fleet.FleetRouter(replicas=3, heartbeat_ms=60000,
                               page_size=4, policy=policy, spawn_fn=spawn,
                               name=f"parity-{pkg}-{policy}", seed=3)
    box["router"] = router
    router.start(wait=True, timeout=30)
    out = {"decisions": [], "tokens": []}
    try:
        a = list(range(1, 17))
        b = list(range(40, 52))

        def beat(rid, depth, prefixes=None):
            msg = fakes[rid].hb(depth, prefixes)
            want = json.loads(json.dumps(msg))
            _wait(lambda: router._handles[rid].hb == want, what="hb")

        beat("r0", 0)
        beat("r1", 1, digests(a, 4)[:3])
        beat("r2", 2, digests(b, 4)[:2])

        def run(prompt, n=3, **kw):
            fut = router.submit(prompt, max_new_tokens=n, **kw)
            toks = fut.result(timeout=20)
            out["decisions"].append(_where(fakes, fut.mid))
            out["tokens"].append(toks)
            return fut

        for prompt in (a, b, [7] * 8, [1, 2], a + [99, 98, 97, 96], b[:8],
                       list(range(60, 80))):
            run(prompt)
        beat("r1", 5)
        run([3] * 12, n=2)
        run(a, n=4, sampling={"temperature": 0.5, "seed": 9})
        out["snap_mid"] = router.stats.snapshot()
        # a drain through the control path: no heal
        out["handoffs"] = router.drain_replica("r1", timeout_ms=0,
                                               timeout=20)
        _wait(lambda: "r1" not in router._handles, what="drain exit")
        run(a)
        # a death with a request on it: rebuilt from the router's
        # record and re-admitted; the heal spawns r3 first
        held = router.submit([_Fake.HOLD] + b, max_new_tokens=6)
        stream = held.stream(timeout=20)
        first = [next(stream), next(stream)]
        victim = _where(fakes, held.mid)
        fakes[victim[0]].kill()
        out["held"] = first + list(stream)
        out["held_where"] = _where(fakes, held.mid)
        _wait(lambda: "r3" in router._handles
              and router.stats.snapshot()["replica_deaths"] == 1,
              what="heal")
        beat("r3", 0)
        run(b)
        run([5] * 9)
        out["snap"] = router.stats.snapshot()
        status = router.status()
        out["status"] = {k: v for k, v in status.items()
                         if k not in ("name", "port")}
        out["ledger"] = router.ledger.snapshot()
    finally:
        router.stop()
    return out


@pytest.mark.parametrize("policy", ["affinity", "least_loaded", "random"])
def test_router_decisions_and_stats_match_the_jax_package(policy):
    want = _router_script("jax", policy)
    got = _router_script("port", policy)
    assert got == want
    assert got["snap"]["replica_deaths"] == 1
    assert got["snap"]["readmissions"] == 1
    assert got["held"] == [_tok([_Fake.HOLD] + list(range(40, 52)), p)
                           for p in range(6)]
    if policy == "affinity":
        assert got["snap_mid"]["routed_affinity"] >= 3
        assert got["snap_mid"]["affinity_pages_covered"] >= 7


# ------------------------------------ affinity, autoscale, drain ledger
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affinity_best_matches_the_jax_package(seed):
    rs = np.random.RandomState(seed)
    rids = [f"r{i}" for i in range(4)]
    heads = [rs.randint(0, 64, size=32).tolist() for _ in range(3)]
    for kv in ("float32", "int8"):
        idx = {"jax": jfleet.AffinityIndex(4, kv),
               "port": tfleet.AffinityIndex(4, kv)}
        for rid in rids:
            head = heads[rs.randint(len(heads))]
            n = int(rs.randint(0, 9))
            adv_kv = ("float32", "int8")[rs.randint(2)]
            for pkg, (_, digests) in PACKAGES.items():
                idx[pkg].update(rid, digests(head, 4, adv_kv)[:n])
        for _ in range(30):
            head = heads[rs.randint(len(heads))]
            prompt = head[:rs.randint(0, 33)] + \
                rs.randint(0, 64, size=rs.randint(0, 6)).tolist()
            cands = [r for r in rids if rs.rand() < 0.8]
            assert idx["port"].best(prompt, cands) == \
                idx["jax"].best(prompt, cands)
        gone = rids[rs.randint(len(rids))]
        for pkg in PACKAGES:
            idx[pkg].remove(gone)
        assert all(idx["port"].advertised(r) == idx["jax"].advertised(r)
                   for r in rids)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscaler_observe_matches_the_jax_package(seed):
    rs = np.random.RandomState(seed)
    for _ in range(4):
        kw = dict(min_replicas=int(rs.randint(1, 3)),
                  max_replicas=int(rs.randint(3, 6)),
                  queue_high=int(rs.randint(4, 10)),
                  queue_low=int(rs.randint(0, 3)),
                  patience=int(rs.randint(1, 4)),
                  p99_high_ms=(None, 50.0)[rs.randint(2)])
        scalers = [jfleet.Autoscaler(**kw), tfleet.Autoscaler(**kw)]
        n = 2
        for _ in range(60):
            depth = float(rs.choice([0, 1, 2, 5, 8, 12]))
            p99 = (None, float(rs.randint(0, 100)))[rs.randint(2)]
            want, got = (s.observe(depth, n, p99_ms=p99) for s in scalers)
            assert got == want
            n = max(1, n + got)
    for cls in (jfleet.Autoscaler, tfleet.Autoscaler):
        with pytest.raises(ValueError):
            cls(queue_high=2, queue_low=2)
    assert tfleet.Autoscaler().queue_high == jfleet.Autoscaler().queue_high


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drain_ledger_matches_the_jax_package(seed):
    rs = np.random.RandomState(seed)
    ledgers = [jfleet.DrainLedger(), tfleet.DrainLedger()]
    for step in range(80):
        op = rs.randint(5)
        rid = f"r{rs.randint(4)}"
        now = float(step)
        if op == 0:
            args = ("begin", rid, now, float(rs.randint(1, 6)))
        elif op == 1:
            args = ("note_handoff", rid)
        elif op == 2:
            args = ("finish", rid, bool(rs.randint(2)))
        elif op == 3:
            args = ("expired", now)
        else:
            args = ("active",)
        want, got = (getattr(led, args[0])(*args[1:]) for led in ledgers)
        assert got == want
        assert ledgers[1].snapshot() == ledgers[0].snapshot()
        assert ledgers[1].draining(rid) == ledgers[0].draining(rid)


# ---------------------------------------------- frames and handoff state
class _Capture:
    def __init__(self):
        self.frames = []

    def send(self, obj):
        self.frames.append(json.loads(json.dumps(obj)))


def test_error_frames_match_the_jax_package():
    frames = []
    for fleet in (jfleet, tfleet):
        chan = _Capture()
        worker = fleet.ReplicaWorker(None, None, chan, "r0",
                                     heartbeat_ms=50)
        worker._send_error("m3", ValueError("bad 'input' ✓"))
        worker._send_error("m4", KeyError("k"))
        frames.append(chan.frames)
    assert frames[1] == frames[0]


def test_port_handoff_state_passes_the_jax_check():
    cfg = tdec.DecoderConfig(vocab=64, d_model=32, n_layers=2, n_heads=2,
                             d_ff=64, max_len=128)
    params = tdec.init_decoder_params(cfg, seed=0)
    server = tserving.ModelServer()
    try:
        server.load_decoder("lm", params, cfg, max_batch=2, page_size=4,
                            num_pages=64, device="cpu")
        prompt = list(range(1, 10))
        fut = server.submit_decode("lm", prompt, max_new_tokens=64,
                                   sampling={"temperature": 0.8,
                                             "seed": 7})
        stream = fut.stream(timeout=60)
        pre = [next(stream)]
        states = server.drain(timeout=0)
    finally:
        server.stop()
    (records,) = states.values()
    state = json.loads(json.dumps(records[0]))
    assert state["generated"][:1] == pre
    checked = jfleet.check_handoff_state(dict(state))
    assert checked == tfleet.check_handoff_state(dict(state))
    assert checked["prompt"] == prompt
    assert checked["sampling"]["seed"] == 7


# ------------------------------------------------- knobs, names, surface
def test_fleet_knobs_match_the_jax_package():
    for name in FLEET_KNOBS:
        t, j = tutils._ENV_REGISTRY[name], jutils._ENV_REGISTRY[name]
        assert (t.type, t.default, t.help) == (j.type, j.default, j.help)
        assert tutils.getenv(name) == jutils.getenv(name)
    assert (tfleet.config.replicas(), tfleet.config.heartbeat_ms(),
            tfleet.config.drain_timeout_ms()) == (2, 200, 5000)


def test_fleet_surface_and_instruments_match_the_jax_package():
    assert tmx.fleet is tfleet
    assert tfleet.__all__ == jfleet.__all__
    assert all(hasattr(tfleet, n) for n in tfleet.__all__)
    names = [n for n in dir(jstats) if n.isupper() and n.startswith("_")
             and hasattr(getattr(jstats, n), "help")]
    assert len(names) == 7
    for n in names:
        t, j = getattr(tstats, n), getattr(jstats, n)
        assert (type(t).__name__, t.name, t.help) == \
            (type(j).__name__, j.name, j.help)
    assert inspect.signature(tfleet.FleetRouter).parameters.keys() - \
        inspect.signature(jfleet.FleetRouter).parameters.keys() == {"ctx"}


# ------------------------------------------- predict through the fleet
def test_predict_through_the_fleet_is_bit_exact(tmp_path):
    data = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(
        tmx.sym.FullyConnected(data, num_hidden=5, name="fc"),
        name="softmax")
    rs = np.random.RandomState(0)
    params = {"arg:fc_weight": rs.randn(5, 3).astype(np.float32),
              "arg:fc_bias": rs.randn(5).astype(np.float32)}
    x = rs.randn(4, 3).astype(np.float32)
    with tmx.cpu():
        model = tserving.ModelRegistry().load(
            "clf", net.tojson(), params, {"data": (3,)},
            batch_buckets=(1, 2, 4))
        bundle = tserving.save_bundle(model, str(tmp_path / "clf.bundle"))
        want = np.asarray(model.infer({"data": x[:1]}, 1, 0)[0])

    def spawn(rid, port):
        def run():
            server = tserving.ModelServer(max_wait_us=0)
            with tmx.cpu():
                served = server.load_bundle(bundle)
            chan = tfleet.Channel(
                socket.create_connection(("127.0.0.1", port)), name=rid)
            tfleet.ReplicaWorker(server, served, chan, rid,
                                 heartbeat_ms=50).run()
            server.stop()
        threading.Thread(target=run, daemon=True).start()

    router = tfleet.FleetRouter(bundle, replicas=1, heartbeat_ms=50,
                                spawn_fn=spawn, name="predict", ctx="cpu")
    router.start(wait=True, timeout=60)
    try:
        got = router.predict({"data": x[0].tolist()}, timeout=30)
        hello = router.status()["replicas"]["r0"]
        assert router.stats.snapshot()["routed_least_loaded"] == 1
    finally:
        router.stop()
    assert hello["model"] == "clf"
    out = np.asarray(got[0], np.float32)
    assert out.shape == want.shape[1:]
    np.testing.assert_array_equal(out, want[0])
