"""The port's stores and fused data plane across two worker processes on
the CPU, against the JAX package's single-process computation of the
same thing (the JAX package is not launched across processes here).

Each run starts tests/torch_dist_worker.py twice through tools/launch.py
(a gloo group over a TCPStore on the loopback device), with its own time
limit of 120 s (one more launch when one fails), and reads each rank's
results back from an .npz file:

- sync: KVStore('dist_sync'): init broadcasts rank 0's value (bit for
  bit), a push of two device copies on each rank sums to the JAX
  package's sum of the ranks' sums (bit for bit: float32 sums in the
  same order), and with an SGD updater on the store the pulled weight is
  the JAX local store's after one push of both ranks' gradients (within
  1e-6: the update's arithmetic in another library); a value placed
  by `parallel.mesh.global_put` over the two processes' data axis holds
  each rank's rows, and `full_host` gathers the whole of it.
- async: KVStore('dist_async'): rank 0's server applies all six pushes,
  the weight is the JAX local store's after the same six SGD pushes
  (within 1e-6: the arrival order may differ), and after rank 1 dies
  rank 0's get_num_dead_node counts it.
- fused: Module.fit's fused step with kvstore='dist_sync' over a conv
  net with a BatchNorm, rank-dependent initial weights, two single steps
  then run_steps(3, stacked=True): both ranks' parameters and moving
  statistics are equal bit for bit, and within 1e-5 (absolute, and
  relative to each tensor's largest magnitude) of the JAX Module's
  fused step over the global batch of 16 from rank 0's initial weights
  (BatchNorm over all 16 rows); each rank's outputs are its rows of the
  JAX step's.
- mp (one launch, a module-scoped fixture, several tests): ring and
  Ulysses attention across the two processes' 'seq' axis, on sequence
  shards and on whole arrays, against the JAX package's dense attention
  and its gradients (2e-4/2e-5 and 1e-3/1e-4); the tower on mesh
  {'seq': 2} with whole inputs (no data_shardings) and with the batch
  split over 'seq', against the JAX Module on the same mesh
  (2e-4/2e-5); the SP+TP tower (mesh {'seq': 2}, data and label split
  "None,seq", w1/w2 sharded over 'seq') against the JAX Module on the
  8-device CPU mesh {'data': 2, 'seq': 4} after 2 and 3 steps
  (2e-4/2e-5), its ranks bit-equal and each storing half of w1/w2's
  bytes (1/(tp*fsdp) with tp = seq = 2); its sharded checkpoint resumed
  bit for bit and restored into a one-process module with no mesh, then
  saved again by that one process into the same directory and loaded
  back bit for bit (the workers' stale part_p1 not assembled); the
  dyadic toy of tests/test_sharding.py under ShardingPlan {'fsdp': 2}
  and {'tp': 2}, bit for bit the JAX package's unsharded run, each
  process storing half the weight, and the sentinel's global rows the
  JAX package's (the maximum exact, the sums within 1e-6, as
  tests/test_numerics.py holds them across shardings).
- pp (one launch, a module-scoped fixture): the PP half of
  test_dist_model_parallel_two_workers (the nightly's 8-stage pipeline,
  16 microbatches, 2 steps, 4 stages a worker, at its 5e-4/5e-5, then
  an inference forward that takes no step); the MoE tower on {'data':
  2} with tokens dropped, each worker its rows and the gating global,
  and on {'expert': 2}, both against the JAX Module's one-process step
  over the global batch (2e-4/2e-5), the ranks bit-equal; a tied
  BatchNorm LM whose tied stages sit on different ranks and a pipeline
  whose boundary carries two tensors, against the JAX package's
  one-process PipelineModule (2e-4/2e-5), the tied copies bit-equal.
"""
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

import pytest  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

RUN_LIMIT_S = 120
UPDATE_TOL = 1e-6
FUSED_TOL = 1e-5


def _launch(mode, out, retries=1):
    """Both workers of `mode`; their results as [rank 0's, rank 1's]. A
    launch that fails is tried once more, as tests/test_dist_kvstore.py
    does: the launcher's free port can be taken by another process of a
    busy suite before worker 0 binds it."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for attempt in range(retries + 1):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
             "2", sys.executable,
             os.path.join(ROOT, "tests", "torch_dist_worker.py"), mode,
             str(out)],
            env=env, capture_output=True, text=True, timeout=RUN_LIMIT_S,
            cwd=ROOT)
        if proc.returncode == 0:
            break
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    print(f"{mode}: two workers in {time.perf_counter() - t0:.1f} s")
    return [dict(np.load(out / f"{mode}-{r}.npz")) for r in range(2)]


def _jnd(a):
    return jmx.nd.array(a, ctx=jmx.cpu())


def test_dist_sync_push_pull(tmp_path):
    got = _launch("sync", tmp_path)
    vals = [worker.sync_values(r) for r in range(2)]
    kv = jmx.kv.create("local")
    kv.init(["m0", "m1", "a", "b"], [_jnd(np.zeros(worker.SHAPE))] * 4)
    # each rank's two device copies summed, then the two sums
    for r in range(2):
        kv.push(f"m{r}", [_jnd(v) for v in vals[r]["a"]])
    m = [jmx.nd.zeros(worker.SHAPE) for _ in range(2)]
    kv.pull(["m0", "m1"], out=m)
    kv.push("a", m)
    kv.push("b", [_jnd(vals[r]["b"]) for r in range(2)])
    a, b = jmx.nd.zeros(worker.SHAPE), jmx.nd.zeros(worker.SHAPE)
    kv.pull(["a", "b"], out=[a, b])
    kv3 = jmx.kv.create("local")
    kv3.set_optimizer(jmx.optimizer.create("sgd", learning_rate=0.5,
                                           rescale_grad=0.25))
    kv3.init(3, _jnd(vals[0]["init"][3]))
    kv3.push(3, [_jnd(vals[r]["g3"]) for r in range(2)])
    w3 = jmx.nd.zeros(worker.SHAPE)
    kv3.pull(3, out=w3)
    for r in range(2):
        assert int(got[r]["num_workers"]) == 2 and int(got[r]["dead"]) == 0
        np.testing.assert_array_equal(got[r]["init"], vals[0]["init"]["a"])
        np.testing.assert_array_equal(got[r]["a"], a.asnumpy())
        np.testing.assert_array_equal(got[r]["b"], b.asnumpy())
        np.testing.assert_allclose(got[r]["w3"], w3.asnumpy(),
                                   rtol=UPDATE_TOL, atol=UPDATE_TOL)
        value = np.arange(24, dtype=np.float32).reshape(4, 6)
        np.testing.assert_array_equal(got[r]["local_rows"],
                                      value[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got[r]["full"], value)


def test_dist_async_and_dead_worker(tmp_path):
    got = _launch("async", tmp_path)
    kv = jmx.kv.create("local")
    kv._set_updater(jmx.optimizer.get_updater(
        jmx.optimizer.create("sgd", learning_rate=0.1)))
    kv.init("w", _jnd(np.full(worker.SHAPE, 1.0, np.float32)))
    for r in range(2):
        for g in worker.async_grads(r):
            kv.push("w", _jnd(g))
    w = jmx.nd.zeros(worker.SHAPE)
    kv.pull("w", out=w)
    assert int(got[0]["alive"]) == int(got[1]["alive"]) == 0
    assert int(got[0]["applied"]) == 6
    assert int(got[0]["dead"]) >= 1, "rank 0 never counted rank 1 dead"
    np.testing.assert_allclose(got[0]["w"], w.asnumpy(), rtol=UPDATE_TOL,
                               atol=UPDATE_TOL)


def _worst(got, want):
    """The largest difference over the tensor's largest magnitude, or
    absolute below 1 (conv_bias before a BatchNorm moves only by
    rounding)."""
    scale = max(float(np.abs(want).max()), 1.0)
    return float(np.abs(got - want).max()) / scale


def test_dist_fused_data_plane_with_batchnorm(tmp_path):
    got = _launch("fused", tmp_path)
    init = {k[len("init/"):]: v for k, v in got[0].items()
            if k.startswith("init/")}
    x, y = worker.fused_batches()
    glob = 2 * worker.LOCAL
    mod = jmx.mod.Module(worker.fused_net(jmx), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (glob,) + worker.IMAGE)],
             label_shapes=[("softmax_label", (glob,))])
    mod.init_params()
    mod.set_params({k[4:]: _jnd(v) for k, v in init.items()
                    if k.startswith("arg:")},
                   {k[4:]: _jnd(v) for k, v in init.items()
                    if k.startswith("aux:")})
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9)))
    assert mod._fused_step is not None
    for i in range(worker.STEPS):
        mod.forward_backward(jmx.io.DataBatch(data=[_jnd(x[i])],
                                              label=[_jnd(y[i])]))
        mod.update()
    first = mod.get_outputs()[0].asnumpy()
    mod.run_steps(jmx.io.DataBatch(data=[_jnd(x[worker.STEPS:])],
                                   label=[_jnd(y[worker.STEPS:])]),
                  worker.K, stacked=True)
    last = mod.get_outputs()[0].asnumpy()
    args, auxs = mod.get_params()
    want = {f"arg:{k}": v.asnumpy() for k, v in args.items()}
    want.update({f"aux:{k}": v.asnumpy() for k, v in auxs.items()})
    assert {f"final/{k}" for k in want} == {
        k for k in got[0] if k.startswith("final/")}
    for k, v in want.items():
        np.testing.assert_array_equal(got[0][f"final/{k}"],
                                      got[1][f"final/{k}"], err_msg=k)
        assert _worst(got[0][f"final/{k}"], v) <= FUSED_TOL, k
    assert float(np.abs(want["aux:bn_moving_mean"]).max()) > 0
    for r in range(2):
        rows = slice(r * worker.LOCAL, (r + 1) * worker.LOCAL)
        assert _worst(got[r]["first_outs"], first[rows]) <= FUSED_TOL
        assert _worst(got[r]["outs"], last[rows]) <= FUSED_TOL
        assert bool(got[r]["staged"])
        assert int(got[r]["partial_rows"]) == worker.LOCAL // 2
        assert int(got[r]["t"]) == worker.STEPS + worker.K + 1
        assert [s.split(":")[0] for s in got[r]["segments"]] == [
            "forward+backward", "all-reduce (1 buffer(s), gloo)", "update"]


# ------------------------------------------------------------- model parallel
MP_TOL = (2e-4, 2e-5)       # the SP+TP tower against the JAX step
RING_TOL = (2e-4, 2e-5)     # ring/Ulysses outputs against dense
GRAD_TOL = (1e-3, 1e-4)     # their gradients


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp")
    return out, _launch("mp", out, retries=2)


def _jax_tower(steps, mesh_shape=None, data_shardings=None):
    """The JAX package's tower on its CPU mesh (by default the SP+TP
    layout on all 8 devices): params after each of `steps` steps, and
    the last step's outputs."""
    from mxnet_tpu.models import get_transformer

    if mesh_shape is None:
        mesh_shape = {"data": 2, "seq": 4}
        data_shardings = {"data": "data,seq", "label": "data,seq"}
    net = get_transformer(tp_axis="seq", **worker.TOWER)
    mod = jmx.mod.Module(
        net, label_names=("label",), context=[jmx.cpu()],
        mesh_shape=mesh_shape, data_shardings=data_shardings)
    d = worker.TOWER["d_model"]
    mod.bind(data_shapes=[("data", (worker.TB, worker.TT, d))],
             label_shapes=[("label", (worker.TB, worker.TT, d))])
    mod.init_params(arg_params={k: _jnd(v)
                                for k, v in worker.tower_init().items()},
                    aux_params={}, force_init=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9)))
    assert mod._fused_step is not None
    got = []
    for x, y in worker.tower_batches(steps, seed=5):
        mod.forward_backward(jmx.io.DataBatch(data=[_jnd(x)],
                                              label=[_jnd(y)]))
        mod.update()
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    return got, mod.get_outputs()[0].asnumpy()


def test_mp_ring_and_ulysses_across_processes(mp_run):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import attention_reference

    _out, got = mp_run
    q, k, v, w = (jnp.asarray(a) for a in worker.attention_inputs())
    loss = lambda q, k, v: (attention_reference(  # noqa: E731
        q, k, v, causal=True) * w).sum()
    ref = np.asarray(attention_reference(q, k, v, causal=True))
    grads = [np.asarray(g) for g in
             jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
    half = worker.QKV[1] // 2
    for r in range(2):
        rows = slice(r * half, (r + 1) * half)
        for impl in ("ring", "ulysses"):
            np.testing.assert_allclose(got[r][f"{impl}/out"], ref[:, rows],
                                       rtol=RING_TOL[0], atol=RING_TOL[1])
            np.testing.assert_allclose(got[r][f"{impl}/whole_out"], ref,
                                       rtol=RING_TOL[0], atol=RING_TOL[1])
            for name, g in zip("qkv", grads):
                np.testing.assert_allclose(
                    got[r][f"{impl}/d{name}"], g[:, rows],
                    rtol=GRAD_TOL[0], atol=GRAD_TOL[1], err_msg=impl + name)
                np.testing.assert_allclose(
                    got[r][f"{impl}/whole_d{name}"], g,
                    rtol=GRAD_TOL[0], atol=GRAD_TOL[1], err_msg=impl + name)


def test_mp_sp_tp_tower_matches_jax_and_halves_storage(mp_run):
    _out, got = mp_run
    steps, outs = _jax_tower(worker.TOWER_STEPS)
    for k, want in steps[1].items():
        np.testing.assert_allclose(got[0][f"ck/{k}"], want, rtol=MP_TOL[0],
                                   atol=MP_TOL[1], err_msg=k)
    for k, want in steps[-1].items():
        for r in range(2):
            np.testing.assert_allclose(got[r][f"tower/{k}"], want,
                                       rtol=MP_TOL[0], atol=MP_TOL[1],
                                       err_msg=k)
        # every parameter, replicated or gathered, bit-equal on the ranks
        np.testing.assert_array_equal(got[0][f"tower/{k}"],
                                      got[1][f"tower/{k}"], err_msg=k)
    for r in range(2):
        np.testing.assert_allclose(got[r]["tower/outs"], outs,
                                   rtol=MP_TOL[0], atol=MP_TOL[1])
    # w1/w2 sharded over 'seq' (tp = 2, no fsdp): each rank stores 1/2
    w_whole = sum(v.nbytes for k, v in steps[-1].items()
                  if k.endswith(("_w1_weight", "_w2_weight")))
    every = sum(v.nbytes for v in steps[-1].values())
    for r in range(2):
        assert int(got[r]["tower/w_bytes"]) * 2 == w_whole
        assert int(got[r]["tower/stored_bytes"]) == every - w_whole // 2
        np.testing.assert_array_equal(
            got[r]["tower/local_w1"],
            got[r]["tower/layer0_ffn_w1_weight"][r * 8:(r + 1) * 8])
        assert [s.split(":")[0] for s in got[r]["tower/segments"]] == [
            "forward+backward", "all-reduce (1 buffer(s), gloo)", "update"]


def test_mp_seq_mesh_with_whole_or_row_split_inputs_matches_jax(mp_run):
    # mesh {'seq': 2} without data_shardings (every process steps on the
    # whole sequence; the ring shards it and gathers its output) and with
    # the batch split over 'seq' (an all-to-all to sequence shards and
    # back), both against the JAX Module on that mesh without
    # data_shardings: the JAX ring takes global arrays in any layout
    _out, got = mp_run
    steps, outs = _jax_tower(worker.TOWER_STEPS, mesh_shape={"seq": 2})
    for tag in ("whole", "rows"):
        for k, want in steps[-1].items():
            for r in range(2):
                np.testing.assert_allclose(got[r][f"{tag}/{k}"], want,
                                           rtol=MP_TOL[0], atol=MP_TOL[1],
                                           err_msg=tag + k)
            np.testing.assert_array_equal(got[0][f"{tag}/{k}"],
                                          got[1][f"{tag}/{k}"],
                                          err_msg=tag + k)
        for r in range(2):
            np.testing.assert_allclose(got[r][f"{tag}/outs"], outs,
                                       rtol=MP_TOL[0], atol=MP_TOL[1])


def test_mp_sharded_checkpoint_resumes_and_restores(mp_run):
    out, got = mp_run
    for r in range(2):
        assert int(got[r]["resumed/t"]) == 2
        for k in (k for k in got[r] if k.startswith("tower/layer")):
            np.testing.assert_array_equal(
                got[r][k.replace("tower/", "resumed/")], got[r][k],
                err_msg=k)
    with open(out / "tower_ck" / "mxnet_tpu_meta.json") as f:
        meta = f.read()
    assert meta == json.dumps(json.loads(meta), sort_keys=True)
    assert json.loads(meta)["sharding"]["layer0_ffn_w1_weight"] == \
        "seq,None"
    # into one process with no mesh: the saved layout differs
    with tmx.cpu():
        mod = worker.tower_module()
        assert mod._fused_step._mesh is None
        tmx.load_sharded(mod, str(out / "tower_ck"))
        params = mod.get_params()[0]
    for k, v in params.items():
        np.testing.assert_array_equal(v.asnumpy(), got[0][f"ck/{k}"],
                                      err_msg=k)


def test_sharded_resave_by_fewer_processes_ignores_stale_parts(mp_run,
                                                                 tmp_path):
    # the two workers' checkpoint saved again by one process into the
    # same directory: part_p1 stays on disk, and the load must not
    # assemble it over the fresh part_p0
    import shutil

    out, _got = mp_run
    ck = tmp_path / "ck"
    shutil.copytree(out / "tower_ck", ck)
    with tmx.cpu():
        mod = worker.tower_module()
        tmx.load_sharded(mod, str(ck))
        worker.tower_steps(mod, worker.tower_batches(1, seed=9))
        tmx.save_sharded(mod, str(ck))
        want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        assert (ck / "part_p1.pt").exists()
        with open(ck / "mxnet_tpu_meta.json") as f:
            assert json.load(f)["processes"] == 1
        back = worker.tower_module()
        assert tmx.load_sharded(back, str(ck))["t"] == 3
        got = {k: v.asnumpy() for k, v in back.get_params()[0].items()}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _jax_toy():
    """The dyadic toy's unsharded JAX run: (weight, sentinel rows)."""
    from mxnet_tpu.numerics import NumericsMonitor

    x, y, w0 = worker.toy_data()
    data = jmx.symbol.Variable("data")
    fc = jmx.symbol.FullyConnected(data, name="out_head", num_hidden=8,
                                   no_bias=True)
    net = jmx.symbol.LinearRegressionOutput(fc, name="lro")
    mod = jmx.mod.Module(net, data_names=("data",),
                         label_names=("lro_label",), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (8, 4))],
             label_shapes=[("lro_label", (8, 8))])
    mod.init_params(arg_params={"out_head_weight": _jnd(w0)},
                    aux_params={}, force_init=True)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    mon = NumericsMonitor(interval=0)
    mon.attach(mod)
    for _ in range(3):
        mod.forward_backward(jmx.io.DataBatch(data=[_jnd(x)],
                                              label=[_jnd(y)]))
        mod.update()
    mon.drain(mod)
    rows = np.asarray([[r["groups"]["out_head"]["grad_norm"],
                        r["groups"]["out_head"]["param_norm"],
                        r["groups"]["out_head"]["grad_max_abs"], r["loss"]]
                       for r in mon.history], np.float64)
    return mod.get_params()[0]["out_head_weight"].asnumpy(), rows


@pytest.mark.parametrize("tag,spec", [("fsdp", "(None, 'fsdp')"),
                                      ("tp", "('tp',)")])
def test_mp_dyadic_plan_parity_storage_and_sentinel(mp_run, tag, spec):
    _out, got = mp_run
    w, rows = _jax_toy()
    for r in range(2):
        assert str(got[r][f"{tag}/spec"]) == spec
        np.testing.assert_array_equal(got[r][f"{tag}/w"], w)
        # the (8, 4) weight split in two: 1/(tp*fsdp) = 1/2 a process
        assert int(got[r][f"{tag}/stored"]) * 2 == w.nbytes
        # the sentinel's rows as tests/test_numerics.py holds them across
        # shardings: the maximum exact, the sums (whose partial-sum
        # order the split changes) within 1e-6
        np.testing.assert_array_equal(got[r][f"{tag}/rows"][:, 2],
                                      rows[:, 2])
        np.testing.assert_allclose(got[r][f"{tag}/rows"], rows, rtol=1e-6)


# ------------------------------------------------ pipelines and experts
PP_TOL = (5e-4, 5e-5)      # the nightly's (tests/nightly/
#                            dist_model_parallel.py)
MOE_TOL = (2e-4, 2e-5)


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    return _launch("pp", out, retries=2)


def _jax_batch_steps(mod, batches, rows=None):
    for x, y in batches:
        mod.forward_backward(jmx.io.DataBatch(data=[_jnd(x)],
                                              label=[_jnd(y)]))
        mod.update()


def test_pp_nightly_pipeline_over_two_workers(pp_run):
    """The PP half of test_dist_model_parallel_two_workers: the 8-stage
    dryrun config, 16 microbatches, 2 steps, 4 stages a worker, against
    the JAX package's one-process pipeline over its 8 devices."""
    jbase = jmx.base
    jbase._name_counters.clear()
    pm = worker.pp_module(jmx, jmx.cpu())
    losses = []
    for x, y in worker.pp_batches():
        pm.forward_backward(jmx.io.DataBatch(data=[_jnd(x)],
                                             label=[_jnd(y)]))
        pm.update()
        losses.append(pm.loss_value)
    want = pm.get_params()[0]["fc_weight"].asnumpy()
    outs = pm.get_outputs()[0].asnumpy()
    pm.forward(jmx.io.DataBatch(data=[_jnd(worker.pp_batches()[0][0])],
                                label=None), is_train=False)
    infer = pm.get_outputs()[0].asnumpy()
    for r in pp_run:
        np.testing.assert_allclose(r["pp/infer"], infer, rtol=PP_TOL[0],
                                   atol=PP_TOL[1])
        assert int(r["pp/t_after_infer"]) == worker.PP_STEPS
        assert int(r["pp/local_stages"]) == worker.PP_STAGES // 2
        np.testing.assert_allclose(r["pp/fc_weight"], want,
                                   rtol=PP_TOL[0], atol=PP_TOL[1])
        np.testing.assert_allclose(r["pp/outs"], outs, rtol=PP_TOL[0],
                                   atol=PP_TOL[1])
        np.testing.assert_allclose(r["pp/losses"], losses, rtol=PP_TOL[0])
    for k in ("pp/fc_weight", "pp/outs", "pp/losses"):
        np.testing.assert_array_equal(pp_run[0][k], pp_run[1][k])


def _jax_moe(batch, batches):
    jmx.base._name_counters.clear()
    mod = worker.moe_module(jmx, jmx.cpu(), batch, None, "local")
    _jax_batch_steps(mod, batches)
    return mod


def test_pp_moe_tower_on_data_axis_gates_globally(pp_run):
    """{'data': 2}: each worker steps on its 4 rows, and the capacity,
    the queue positions and the aux loss are those of both workers' 8
    rows (tokens dropped): the JAX package's one-process step over the
    global batch."""
    mod = _jax_moe(2 * worker.MB, worker.moe_batches(2 * worker.MB))
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    outs = mod.get_outputs()[0].asnumpy()
    aux = float(mod.get_outputs()[1].asnumpy())
    for rank, r in enumerate(pp_run):
        assert int(r["data/dropped"]) > 0 and int(r["data/batch_scale"]) == 2
        for k in want:
            np.testing.assert_allclose(r[f"data/{k}"], want[k],
                                       rtol=MOE_TOL[0], atol=MOE_TOL[1],
                                       err_msg=k)
        rows = slice(rank * worker.MB, (rank + 1) * worker.MB)
        np.testing.assert_allclose(r["data/outs"], outs[rows],
                                   rtol=MOE_TOL[0], atol=MOE_TOL[1])
        np.testing.assert_allclose(float(r["data/aux"]), aux,
                                   rtol=MOE_TOL[0], atol=MOE_TOL[1])
    for k in want:
        np.testing.assert_array_equal(pp_run[0][f"data/{k}"],
                                      pp_run[1][f"data/{k}"])


def test_pp_moe_tower_on_expert_axis_ranks_bit_equal(pp_run):
    """{'expert': 2}: the whole batch on both workers, each computing 2
    of the 4 experts' FFN, the ranks bit-equal, the JAX package's step."""
    mod = _jax_moe(2 * worker.MB, worker.moe_batches(2 * worker.MB))
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for r in pp_run:
        assert int(r["expert/computed"]) * 2 == int(r["expert/experts"])
        assert int(r["expert/bytes"]) > 0
        for k in want:
            np.testing.assert_allclose(r[f"expert/{k}"], want[k],
                                       rtol=MOE_TOL[0], atol=MOE_TOL[1],
                                       err_msg=k)
    for k in list(want) + ["outs"]:
        np.testing.assert_array_equal(pp_run[0][f"expert/{k}"],
                                      pp_run[1][f"expert/{k}"])


def test_pp_tied_hetero_pipeline_across_ranks(pp_run):
    """A 4-stage LM with a BatchNorm, its head tied to the embedding:
    stage 0 on rank 0, stage 3 on rank 1, each rank binding its own
    stages' executors alone. The copies stay bit-equal on
    both ranks; parameters and moving statistics are the JAX package's
    one-process pipeline's after 3 steps."""
    jmx.base._name_counters.clear()
    pm = worker.tied_module(jmx, jmx.cpu())
    losses = []
    for x, y in worker.tied_batches():
        pm.forward_backward(jmx.io.DataBatch(data=[_jnd(x)],
                                             label=[_jnd(y)]))
        pm.update()
        losses.append(pm.loss_value)
    args, auxs = pm.get_params()
    for rank, r in enumerate(pp_run):
        assert int(r["tied/local_rows"]) == 2
        # each rank binds executors for its own two stages alone
        assert list(r["tied/bound_stages"]) == [2 * rank, 2 * rank + 1]
        np.testing.assert_array_equal(r["tied/stage0/emb_weight"],
                                      r["tied/stage3/head_weight"])
        for k, v in args.items():
            np.testing.assert_allclose(r[f"tied/{k}"], v.asnumpy(),
                                       rtol=MOE_TOL[0], atol=MOE_TOL[1],
                                       err_msg=k)
        for k, v in auxs.items():
            np.testing.assert_allclose(r[f"tied_aux/{k}"], v.asnumpy(),
                                       rtol=MOE_TOL[0], atol=MOE_TOL[1],
                                       err_msg=k)
        np.testing.assert_allclose(r["tied/losses"], losses,
                                   rtol=MOE_TOL[0])
    np.testing.assert_array_equal(pp_run[0]["tied/stage0/emb_weight"],
                                  pp_run[1]["tied/stage3/head_weight"])


def test_pp_multi_boundary_pipeline_across_ranks(pp_run):
    """Two boundary tensors (data, data1) cross from rank 0's stage to
    rank 1's: parameters after 3 steps the JAX package's one-process
    pipeline's (tests/test_pipeline_moe.py's multi-input case)."""
    jmx.base._name_counters.clear()
    pm = worker.multi_module(jmx, jmx.cpu())
    losses = []
    for x, y in worker.multi_batches():
        pm.forward_backward(jmx.io.DataBatch(data=[_jnd(x)],
                                             label=[_jnd(y)]))
        pm.update()
        losses.append(pm.loss_value)
    want = {k: v.asnumpy() for k, v in pm.get_params()[0].items()}
    for r in pp_run:
        for k, v in want.items():
            np.testing.assert_allclose(r[f"multi/{k}"], v, rtol=MOE_TOL[0],
                                       atol=MOE_TOL[1], err_msg=k)
        np.testing.assert_allclose(r["multi/losses"], losses,
                                   rtol=MOE_TOL[0])
