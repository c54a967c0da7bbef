"""The elastic tier of the port (`mxnet_tpu_torch.elastic`) against the JAX
package's (`mxnet_tpu.elastic`), on the CPU.

- tests/test_elastic.py's 21 tests replayed on the port: the reference
  test source with `mxnet_tpu` read as `mxnet_tpu_torch`, run under
  `with mx.cpu():`. Its `fit_elastic` call runs in a thread of its own,
  which does not inherit the test's context, so the replay passes it
  `ctx=mx.cpu()`. The case the reference marks slow (two in-process
  jobs, seconds on the port) runs unmarked.
- Parity with the JAX package, each bit for bit unless a bound is
  stated: the JSON of `encode_tree` and the `digest` of the same arrays;
  `placement`, `member_moves` and the byte counts; the sampler streams
  after a re-key; `ci_job`'s graph JSON, data and initial parameters;
  `combine_grads` and `ElasticSGD`; the six MXNET_ELASTIC_* knobs and
  the instruments. One whole `ci_job` run through each package's
  coordinator ends within 1e-5 of each parameter's largest magnitude
  (the two packages' float32 gradients differ in their last bits, and 32
  momentum steps carry that along).
- The port's own shrink and grow in one job: a worker leaves after step
  5, another joins after step 9, and the final parameters equal the
  uninterrupted run's with `np.array_equal`; every (epoch, shard, step)
  batch is consumed exactly once with the sampler's indices, and no
  member builds a bind plan after its warmup.
- A.13: `count_flops` (tests/test_layout.py's two cases), `print_summary`
  (tests/test_monitor_profiler.py's), `describe_env`, `num_devices`,
  `memory_stats`, `cpu_pinned` and `set_memory_fraction`'s refusal
  after the first device use.
"""
import ast
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx  # noqa: F401  (the JAX package's registry)
import mxnet_tpu_torch as tmx
from mxnet_tpu import utils as jutils
from mxnet_tpu.data import sampler as jsampler
from mxnet_tpu.elastic import (ElasticCoordinator as JCoordinator,
                               ElasticWorker as JWorker)
from mxnet_tpu.elastic import codec as jcodec
from mxnet_tpu.elastic import reshard as jreshard
from mxnet_tpu.elastic import stats as jstats
from mxnet_tpu.elastic import trainer as jtrainer
from mxnet_tpu_torch import utils as tutils
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import sampler as tsampler
from mxnet_tpu_torch.elastic import (ElasticCoordinator, ElasticWorker,
                                     codec, reshard)
from mxnet_tpu_torch.elastic import stats as tstats
from mxnet_tpu_torch.elastic import trainer as ttrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_ndarray import ROOT  # noqa: E402

ENTRY = "mxnet_tpu_torch.elastic.ci_job:build"
JENTRY = "mxnet_tpu.elastic.ci_job:build"
ELASTIC_KNOBS = ("MXNET_ELASTIC_PORT", "MXNET_ELASTIC_HEARTBEAT_MS",
                 "MXNET_ELASTIC_QUIESCE_TIMEOUT_MS",
                 "MXNET_ELASTIC_LOGICAL_SHARDS", "MXNET_ELASTIC_MIN_WORLD",
                 "MXNET_ELASTIC_REJOIN_MS")
# one whole ci_job run in each package: each parameter within this share
# of its largest magnitude
RUN_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _own_jax_disk_root(tmp_path_factory):
    """The JAX reference runs build under an empty exec-cache disk root
    of this module's own, with no bundle overlay mounted (a program
    another test left in the worker's shared root, built for another
    device layout, is never replayed here)."""
    from mxnet_tpu import exec_cache_disk as jdisk

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_EXEC_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_exec_cache")))
        mp.setattr(jdisk, "_overlays", [])
        yield


@pytest.fixture(autouse=True)
def _no_elastic_knobs(monkeypatch):
    for var in ELASTIC_KNOBS + ("MXNET_TPU_FAULT_INJECT",):
        monkeypatch.delenv(var, raising=False)


def _wait_for(cond, deadline_s, what):
    """Poll `cond` until it holds or `deadline_s` passes (a deadline on a
    counter, not a fixed sleep)."""
    end = time.monotonic() + deadline_s
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        threading.Event().wait(0.01)


# --------------------------------------- tests/test_elastic.py, replayed
class _CpuFitElastic(ast.NodeTransformer):
    """`mx.model.fit_elastic(...)` -> the same call with ctx=mx.cpu():
    it runs in a thread of its own, outside the test's `with` scope."""

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "fit_elastic":
            node.keywords.append(ast.keyword(
                arg="ctx", value=ast.parse("mx.cpu()").body[0].value))
        return node


def _replay_elastic():
    path = ROOT / "tests" / "test_elastic.py"
    tree = _CpuFitElastic().visit(ast.parse(path.read_text()))
    src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch",
                 ast.unparse(ast.fix_missing_locations(tree)))
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


ELASTIC = _replay_elastic()
ELASTIC_TESTS = sorted(n for n in ELASTIC if n.startswith("test_"))


def test_every_reference_case_replayed():
    tree = ast.parse((ROOT / "tests" / "test_elastic.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert len(names) == 21 and sorted(names) == ELASTIC_TESTS
    slow = [n for n in ELASTIC_TESTS
            if any(m.name == "slow"
                   for m in getattr(ELASTIC[n], "pytestmark", []))]
    assert slow == ["test_shrink_and_grow_bitwise_identical"]


@pytest.mark.parametrize("name", ELASTIC_TESTS)
def test_elastic_replayed(name, capsys):
    fn = ELASTIC[name]
    with tmx.cpu():
        fn()


# ------------------------------------------------------ codec and frames
def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(16, 12).astype(np.float32),
            "fc1_bias": rs.randn(16).astype(np.float32),
            "count": np.arange(5, dtype=np.int64),
            "scalar": np.float32(rs.randn()).reshape(()),
            "half": rs.randn(3, 2).astype(np.float16),
            "strided": rs.randn(6, 4).astype(np.float32)[::2, ::-1]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_and_digests_equal_the_jax_package(seed):
    tree = _tree(seed)
    t, j = codec.encode_tree(tree), jcodec.encode_tree(tree)
    assert json.dumps(t) == json.dumps(j)
    assert codec.digest(tree) == jcodec.digest(tree)
    assert codec.payload_bytes(t) == jcodec.payload_bytes(j)
    for name, arr in codec.decode_tree(j).items():
        want = np.ascontiguousarray(tree[name])
        assert arr.dtype == want.dtype and np.array_equal(arr, want)
    big = np.arange(6, dtype=">f4").reshape(2, 3)
    assert codec.encode(big) == jcodec.encode(big)


# -------------------------------------------------------- reshard tables
SHAPES = [
    {"fc1_weight": (16, 12), "fc1_bias": (16,), "fc2_weight": (4, 16),
     "fc2_bias": (4,)},
    # LeNet (models/lenet.py) at its published width
    {"convolution0_weight": (20, 1, 5, 5), "convolution0_bias": (20,),
     "convolution1_weight": (50, 20, 5, 5), "convolution1_bias": (50,),
     "fullyconnected0_weight": (500, 800), "fullyconnected0_bias": (500,),
     "fullyconnected1_weight": (10, 500), "fullyconnected1_bias": (10,)},
    {"odd": (7, 3), "scalar": (), "big": (4096, 3), "row": (6,)},
]


@pytest.mark.parametrize("shapes", SHAPES, ids=["mlp", "lenet", "mixed"])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_placement_and_moves_equal_the_jax_package(shapes, world):
    t_bounds, t_specs = reshard.placement(shapes, world)
    j_bounds, j_specs = jreshard.placement(shapes, world)
    assert t_specs == j_specs and t_bounds == j_bounds
    wids = [f"w{i:03d}" for i in range(world)]
    old = reshard.assignment(t_bounds, wids)
    assert old == jreshard.assignment(j_bounds, wids)
    for new_world in (1, 2, 3):
        nb, _ = reshard.placement(shapes, new_world)
        # a survivor set and a joiner: w000 stays, w001 leaves, w009 joins
        new_wids = (["w000", "w009", "w002", "w003"])[:new_world]
        new = reshard.assignment(nb, new_wids)
        moves = reshard.member_moves(old, new)
        assert moves == jreshard.member_moves(old, new)
        assert reshard.moves_bytes(moves, shapes) == \
            jreshard.moves_bytes(moves, shapes)
    assert reshard.state_bytes(shapes, copies=2 * world) == \
        jreshard.state_bytes(shapes, copies=2 * world)


@pytest.mark.parametrize("n,bs,S,world,consumed,seed,epoch", [
    (256, 8, 2, 1, 0, 7, 0), (256, 8, 2, 1, 5, 7, 1),
    (360, 6, 3, 2, 4, 5, 2), (1024, 64, 2, 1, 5, 0, 1),
    (240, 8, 4, 3, 2, 3, 0)])
def test_sampler_streams_equal_the_jax_package(n, bs, S, world, consumed,
                                               seed, epoch):
    for rank in range(world):
        t = tsampler.ShardedSampler(n, bs, seed=seed, shard_id=0,
                                    num_shards=S)
        j = jsampler.ShardedSampler(n, bs, seed=seed, shard_id=0,
                                    num_shards=S)
        for s in (t, j):
            s.set_epoch(epoch)
            s.set_membership(rank, world, consumed=consumed)
        assert t.owned_shards == j.owned_shards
        assert np.array_equal(t.epoch_indices(), j.epoch_indices())
        for shard in t.owned_shards:
            for p in range(t.batches_per_epoch):
                assert np.array_equal(t.shard_batch(shard, p),
                                      j.shard_batch(shard, p))
    assert np.array_equal(
        tsampler.remainder_stream(seed, epoch, n, S, bs, consumed=consumed),
        jsampler.remainder_stream(seed, epoch, n, S, bs, consumed=consumed))


# ------------------------------------------------------ ci_job, arithmetic
@pytest.mark.parametrize("config", [{}, {"hidden": 24, "data_seed": 9,
                                         "logical_shards": 4, "seed": 3}])
def test_ci_job_data_and_initial_params_equal_the_jax_package(config):
    # the auto-named activation takes its name from a fresh counter in
    # each package, whatever other tests built before in this process
    tmx.base._name_counters.clear()
    t = ttrainer.load_entry(ENTRY)(config)
    jmx.base._name_counters.clear()
    j = jtrainer.load_entry(JENTRY)(config)
    assert t.symbol.tojson() == j.symbol.tojson()
    assert np.array_equal(t.data, j.data) and t.data.dtype == j.data.dtype
    assert np.array_equal(t.label, j.label)
    for key in ("batch_size", "logical_shards", "epochs", "seed", "lr",
                "momentum", "num_samples", "batches_per_epoch",
                "total_steps", "label_name"):
        assert getattr(t, key) == getattr(j, key), key
    shapes = t.param_shapes()
    assert shapes == j.param_shapes()
    tp, jp = t.initial_params(shapes), j.initial_params(shapes)
    assert sorted(tp) == sorted(jp)
    for n in tp:
        assert tp[n].dtype == jp[n].dtype and np.array_equal(tp[n], jp[n])
    ts, js = t.make_sampler(), j.make_sampler()
    for s in (ts, js):
        s.set_epoch(1)
        s.set_membership(0, 1)
    for p in range(t.batches_per_epoch):
        for shard in range(t.logical_shards):
            idx = ts.shard_batch(shard, p)
            assert np.array_equal(idx, js.shard_batch(shard, p))
            for a, b in zip(t.batch_arrays(idx), j.batch_arrays(idx)):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_combine_grads_and_sgd_bit_for_bit(S):
    rs = np.random.RandomState(S)
    grads = {s: {"w": rs.randn(12, 5).astype(np.float32),
                 "b": rs.randn(5).astype(np.float32)} for s in range(S)}
    t, j = ttrainer.combine_grads(grads, S), jtrainer.combine_grads(grads, S)
    for n in t:
        assert np.array_equal(t[n], j[n])
    p = rs.randn(12, 5).astype(np.float32)
    m = rs.randn(12, 5).astype(np.float32)
    tp, tm, jp, jm = p.copy(), m.copy(), p.copy(), m.copy()
    for _ in range(4):
        ttrainer.ElasticSGD(0.05, 0.9).update(tp, t["w"], tm)
        jtrainer.ElasticSGD(0.05, 0.9).update(jp, j["w"], jm)
    assert np.array_equal(tp, jp) and np.array_equal(tm, jm)
    assert ttrainer.ElasticSGD(0.05, 0.9).init_state({"w": (3, 2)})["w"] \
        .dtype == np.float32
    with pytest.raises(MXNetError):
        ttrainer.combine_grads({0: grads[0]}, S + 1)


def _run_job(coord_cls, worker_cls, entry, name, ctx=None):
    c = coord_cls(entry, {}, name=name, initial_world=1).start()
    try:
        if ctx is not None:
            with ctx:
                w = worker_cls(f"127.0.0.1:{c.port}", entry, {}, name=name)
        else:
            w = worker_cls(f"127.0.0.1:{c.port}", entry, {}, name=name)
        out = {}
        th = threading.Thread(target=lambda: out.update(r=w.run(
            rejoin_ms=0)), daemon=True)
        th.start()
        assert c.wait(120), c.status()
        th.join(30)
        assert out["r"][0] == "complete"
        return c.final_params()
    finally:
        c.stop()


def test_ci_job_run_matches_the_jax_package():
    """One whole ci_job run (32 steps, 2 logical shards, momentum SGD)
    through each package's coordinator and one worker."""
    t = _run_job(ElasticCoordinator, ElasticWorker, ENTRY, "t_parity",
                 ctx=tmx.cpu())
    j = _run_job(JCoordinator, JWorker, JENTRY, "j_parity")
    assert sorted(t) == sorted(j)
    shapes = ttrainer.load_entry(ENTRY)({}).param_shapes()
    init = ttrainer.load_entry(ENTRY)({}).initial_params(shapes)
    for n in t:
        scale = np.abs(j[n]).max()
        assert np.abs(t[n] - j[n]).max() <= RUN_RTOL * scale, n
        assert np.abs(t[n] - init[n]).max() > 1e3 * RUN_RTOL * scale, n


# -------------------------------------------- the port's shrink and grow
def _audit(logs, spec):
    """Every (epoch, shard, step) of the job consumed exactly once, each
    with the indices the one-member sampler gives it."""
    seen = {}
    for path in logs:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                key = (rec["epoch"], rec["shard"], rec["step"])
                assert key not in seen, f"{key} consumed twice"
                seen[key] = rec["idx"]
    truth = spec.make_sampler()
    for epoch in range(spec.epochs):
        truth.set_epoch(epoch)
        truth.set_membership(0, 1)
        for p in range(spec.batches_per_epoch):
            for s in range(spec.logical_shards):
                assert seen.pop((epoch, s, p)) == \
                    truth.shard_batch(s, p).tolist(), (epoch, s, p)
    assert not seen, f"batches outside the job: {sorted(seen)}"


def test_shrink_then_grow_bit_identical_in_one_job(tmp_path):
    spec = ttrainer.load_entry(ENTRY)({})
    ref = _run_job(ElasticCoordinator, ElasticWorker, ENTRY, "t_ref1",
                   ctx=tmx.cpu())
    c = ElasticCoordinator(ENTRY, {}, name="t_shrink_grow",
                           workdir=str(tmp_path / "job"),
                           initial_world=2).start()
    logs = [str(tmp_path / f"w{i}.jsonl") for i in range(3)]
    results = {}

    def spawn(i):
        with tmx.cpu():
            w = ElasticWorker(f"127.0.0.1:{c.port}", ENTRY, {},
                              name=f"sg-w{i}", consumed_log=logs[i])

        def run():
            try:
                results[i] = w.run(rejoin_ms=0)
            except MXNetError as e:     # the closed victim
                results[i] = ("lost", str(e))

        threading.Thread(target=run, daemon=True).start()
        return w

    try:
        w0, w1 = spawn(0), spawn(1)
        _wait_for(lambda: w1.completed_steps >= 5, 60, "step 5")
        w1.close()
        _wait_for(lambda: estats_of("t_shrink_grow")["transitions_shrink"]
                  == 1 and c.status()["step"] >= 9, 60, "the shrink")
        w2 = spawn(2)
        assert c.wait(120), c.status()
        got = c.final_params()
        snap = estats_of("t_shrink_grow")
        rows = c.status()["members"]
    finally:
        c.stop()
    for n in ref:
        assert np.array_equal(ref[n], got[n]), n
    assert snap["transitions_shrink"] == 1 and snap["transitions_grow"] == 1
    assert snap["digest_mismatches"] == 0
    assert 0 < snap["reshard_bytes_moved"] < \
        snap["reshard_bytes_full_restore"]
    assert snap["steps_completed"] == spec.total_steps
    _audit(logs, spec)
    # each member's exec cache built its one plan at the warmup, before
    # its hello: no trace after it
    for row in rows:
        assert [t for _, t in row["trace_history"]] in ([], [row["traces"]]), \
            row
    for w in (w0, w2):
        assert all(v.device.type == "cpu"
                   for v in w.stepper.device_params().values())
    with open(tmp_path / "job" / "runlog.jsonl") as f:
        events = [json.loads(line) for line in f]
    phases = [(e.get("event"), e.get("phase"), e.get("direction"))
              for e in events if e.get("event") in ("transition",
                                                    "membership")]
    assert ("transition", "resume", "shrink") in phases
    assert ("transition", "resume", "grow") in phases
    metas = sorted(p for p in os.listdir(tmp_path / "job")
                   if p.startswith("transition-g"))
    with open(tmp_path / "job" / metas[0] / "meta.json") as f:
        meta = json.load(f)
    assert meta["format"] == "mxnet_tpu/elastic_transition_v1"
    assert meta["world"] == 2 and meta["logical_shards"] == 2


def test_heartbeat_pairs_each_step_with_its_digest(monkeypatch):
    """A heartbeat carries the last completed step and the digest of the
    parameters after it, read as one pair: with the commit's consumed-log
    write slowed and the workers beating every 5 ms (the coordinator
    declares a member dead after 5 of its own 50 ms periods), two
    members never disagree."""
    from mxnet_tpu_torch.elastic import agent

    orig = agent.ElasticWorker._log_consumed

    def slow_log(self, *a):
        orig(self, *a)
        threading.Event().wait(0.02)

    monkeypatch.setattr(agent.ElasticWorker, "_log_consumed", slow_log)
    c = ElasticCoordinator(ENTRY, {"epochs": 1}, name="t_hb_pairs",
                           initial_world=2, heartbeat_ms=50).start()
    try:
        workers = []
        for i in range(2):
            with tmx.cpu():
                w = ElasticWorker(f"127.0.0.1:{c.port}", ENTRY,
                                  {"epochs": 1}, name=f"hb-w{i}",
                                  heartbeat_ms=5)
            threading.Thread(target=lambda w=w: w.run(rejoin_ms=0),
                             daemon=True).start()
            workers.append(w)
        assert c.wait(120), c.status()
        snap = estats_of("t_hb_pairs")
    finally:
        c.stop()
    assert snap["steps_completed"] == 16
    assert snap["digest_mismatches"] == 0


def estats_of(job):
    return tstats.elastic_stats()[job]


def test_fit_elastic_trains_ci_job_to_complete_on_the_cpu():
    c = ElasticCoordinator(ENTRY, {}, name="t_fit_cpu",
                           initial_world=1).start()
    try:
        out = {}
        th = threading.Thread(target=lambda: out.update(r=tmx.model.fit_elastic(
            f"127.0.0.1:{c.port}", ENTRY, {}, num_retries=0, ctx=tmx.cpu())),
            daemon=True)
        th.start()
        assert c.wait(120), c.status()
        th.join(30)
        reason, params = out["r"]
        assert reason == "complete"
        for n, v in c.final_params().items():
            assert np.array_equal(v, params[n])
    finally:
        c.stop()


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="a card is present: the default context exists")
def test_agent_without_a_card_exits_before_hello():
    """With no card and no `--ctx cpu` the agent raises before it dials:
    the coordinator never sees a hello."""
    from mxnet_tpu_torch.elastic import agent

    c = ElasticCoordinator(ENTRY, {}, name="t_nocard",
                           initial_world=1).start()
    try:
        with pytest.raises(MXNetError, match="no CUDA device"):
            agent.main(["--connect", f"127.0.0.1:{c.port}", "--entry",
                        ENTRY])
        with pytest.raises(MXNetError, match="no CUDA device"):
            tmx.model.fit_elastic(f"127.0.0.1:{c.port}", ENTRY, {})
        assert c.status()["members"] == []
    finally:
        c.stop()


def test_module_with_auxiliary_states_refused_as_in_the_jax_package():
    """ModuleStepper installs with no auxiliary states and
    allow_missing=False, so a BatchNorm model is refused at install in
    both packages."""
    def spec(mx, trainer):
        d = mx.sym.Variable("data")
        h = mx.sym.BatchNorm(mx.sym.FullyConnected(d, num_hidden=4,
                                                   name="fc"), name="bn")
        net = mx.sym.SoftmaxOutput(h, name="softmax")
        rs = np.random.RandomState(0)
        return trainer.JobSpec(net, rs.rand(32, 3), rs.randint(0, 4, 32),
                               batch_size=8, logical_shards=2, epochs=1)

    with tmx.cpu():
        t = ttrainer.ModuleStepper(spec(tmx, ttrainer))
    j = jtrainer.ModuleStepper(spec(jmx, jtrainer))
    for stepper in (t, j):
        with pytest.raises(RuntimeError, match="is not presented"):
            stepper.install(stepper.params())


# ---------------------------------------------------- knobs, instruments
def test_knobs_equal_the_jax_package():
    for name in ELASTIC_KNOBS:
        t, j = tutils._ENV_REGISTRY[name], jutils._ENV_REGISTRY[name]
        assert (t.type, t.default, t.help) == (j.type, j.default, j.help)
    text = tutils.describe_env()
    for name in ELASTIC_KNOBS:
        assert f"{name}=" in text
    assert sorted(tmx.elastic.__all__) == sorted(jmx.elastic.__all__)


def test_instruments_and_view_equal_the_jax_package():
    for name in ("_MEMBERS", "_TRANSITIONS", "_RESHARD_BYTES",
                 "_QUIESCE_WALL", "_REKEYED"):
        t, j = getattr(tstats, name), getattr(jstats, name)
        assert (t.name, t.help) == (j.name, j.help)
    for mod in (tstats, jstats):
        st = mod.ElasticStats("parityjob")
        st.note_membership(2, 1)
        st.note_step(3)
        st.note_transition("grow", 2.5, 10, 40, 16)
        st.note_digest_mismatch()
    assert tstats.ElasticStats("a").snapshot() == \
        jstats.ElasticStats("a").snapshot()


# ------------------------------------------------------------------ A.13
def _replay_function(test_file, name, fixture_free=True):
    src = (ROOT / "tests" / test_file).read_text()
    src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", src)
    ns = {"__name__": f"replay_{test_file}", "__file__": test_file}
    exec(compile(src, test_file, "exec"), ns)
    return ns[name]


@pytest.mark.parametrize("name", ["test_count_flops_resnet50_analytic",
                                  "test_count_flops_fc_exact"])
def test_count_flops_replayed(name):
    with tmx.cpu():
        _replay_function("test_layout.py", name)()


def test_count_flops_equals_the_jax_package():
    from mxnet_tpu.utils.flops import count_flops as jflops
    from mxnet_tpu_torch.utils.flops import count_flops as tflops

    from mxnet_tpu.models import get_lenet as jlenet

    for pkg, fn in ((jmx, jflops), (tmx, tflops)):
        lenet = jlenet if pkg is jmx else tmx.models.get_lenet
        net = lenet(num_classes=10)
        out = fn(net, data=(64, 1, 28, 28), softmax_label=(64,))
        if pkg is jmx:
            want = out
        else:
            assert out == want


def test_print_summary_replayed(capsys):
    fn = _replay_function("test_monitor_profiler.py", "test_print_summary")
    with tmx.cpu():
        fn(capsys)


def test_print_summary_prints_what_the_jax_package_prints(capsys):
    from mxnet_tpu.models import get_lenet as jlenet

    for pkg in (jmx, tmx):
        lenet = jlenet if pkg is jmx else tmx.models.get_lenet
        pkg.base._name_counters.clear()
        net = lenet(num_classes=10)
        total = pkg.visualization.print_summary(
            net, shape={"data": (64, 1, 28, 28)})
        text = capsys.readouterr().out
        if pkg is jmx:
            want = (total, text)
        else:
            assert (total, text) == want
    assert tmx.viz is tmx.visualization


def test_plot_network_needs_graphviz(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_graphviz(name, *a, **kw):
        if name == "graphviz":
            raise ImportError("no graphviz")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_graphviz)
    net = tmx.models.get_lenet(num_classes=10)
    with pytest.raises(MXNetError, match="graphviz"):
        tmx.viz.plot_network(net)


def test_describe_env_lists_every_registered_knob():
    lines = tutils.describe_env().splitlines()
    assert len(lines) == len(tutils._ENV_REGISTRY)
    assert [ln.split("=", 1)[0] for ln in lines] == \
        sorted(tutils._ENV_REGISTRY)
    assert "MXNET_ELASTIC_MIN_WORLD=1 (default 1) — " in \
        tutils.describe_env()


def test_num_devices_memory_stats_and_cpu_pinned():
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert tmx.num_devices("gpu") == cards
    assert tmx.num_devices("cpu") == 1 and tmx.num_devices("tpu") == 0
    assert tmx.memory_stats(tmx.cpu()) == {}
    with tmx.cpu():
        assert tmx.memory_stats() == {}
    pinned = tmx.cpu_pinned()
    assert pinned.device_type == "cpu_pinned" and repr(pinned) == \
        "cpu_pinned(0)"
    assert pinned.torch_device() == torch.device("cpu")
    with pinned:
        assert tmx.nd.ones((2,)).asnumpy().tolist() == [1.0, 1.0]


def test_set_memory_fraction_refused_after_the_first_device_use(
        monkeypatch):
    import torch

    from mxnet_tpu_torch import context

    monkeypatch.setattr(context, "_MEM_FRACTION", {})
    queued = []
    monkeypatch.setattr(torch.cuda, "_lazy_call", queued.append)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    tmx.set_memory_fraction(0.5)
    assert context._MEM_FRACTION == {"fraction": 0.5, "preallocate": False}
    assert queued == [context._apply_mem_fraction]
    with pytest.raises(MXNetError, match="not in"):
        tmx.set_memory_fraction(1.5)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(MXNetError, match="before the first device use"):
        tmx.set_memory_fraction(0.25)
    assert context._MEM_FRACTION["fraction"] == 0.5
