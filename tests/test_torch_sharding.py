"""The model-parallel half of the multi-device slice on one process, on
the CPU, against the JAX package on its 8 virtual CPU devices.

The port's host counts 8 devices here (`parallel.mesh._count_local`
patched), so a mesh of cpu(0..7) is one device's global program
(parallel/mesh.py):
parameters stay whole, the specs are resolved and recorded as the JAX
package resolves them, and RingAttention runs the ring's shards one
after another. The same numpy-seeded inputs go through both packages:

- ShardingPlan: digests, `rules_digest`, resolved specs and `describe()`
  equal the JAX package's, string for string;
- tests/test_sharding.py replayed (its storage half needs processes:
  `test_dp_tp_fsdp_parity_and_storage` keeps its bit parity, specs and
  gather set here, and tests/test_torch_dist.py holds each of two
  processes to half the weight's bytes);
- ring and Ulysses attention against the JAX package's ring and dense
  attention (2e-4/2e-5) and their gradients (1e-3/1e-4);
- tests/test_module_mesh.py (DP, SP+TP, MoE over {'data': 2,
  'expert': 4}, the PipelineModule cases of both tiers, the unknown
  axis; three cases' own JAX arithmetic in torch, `ADAPT`),
  tests/test_checkpoint_sharded.py and tests/test_model_parallel.py
  replayed; the SP+TP tower against the JAX Module after 3 steps
  (2e-4/2e-5); the dyadic sentinel rows of tests/test_numerics.py across
  shardings;
- tests/test_decoding.py's seq_mesh_for and ring-prefill cases on the
  port, the ring prefill's greedy stream against the JAX package's
  dense reference.
"""
import inspect
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_ndarray import replay  # noqa: E402


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


RING_TOL = (2e-4, 2e-5)
REPLAY_NP_SEED = 0
GRAD_TOL = (1e-3, 1e-4)
STEP_TOL = (2e-4, 2e-5)

# reference cases that need several processes
NOT_REPLAYED = {
    "test_sharding.py::test_dp_tp_fsdp_parity_and_storage":
        "storage needs processes: test_dp_tp_fsdp_parity_and_specs here, "
        "tests/test_torch_dist.py for the bytes",
}
# the reference's own JAX arithmetic in three cases, in torch: its
# reference compositions call `Executor._run_graph` in the JAX package's
# argument order with jax arrays and differentiate with jax.grad, and a
# JAX array read before a step is a snapshot (the port's step updates
# its tensors in place, so the replay copies it)
ADAPT = {"test_module_mesh.py": [
    ("    before_np = np.asarray(before)\n",
     "    before_np = np.array(before)\n"),
    ("""            outs, _ = ex._run_graph(
                {**args, "data": h}, {}, jax.random.PRNGKey(0), True)""",
     """            outs, _ = ex._run_graph({**args, "data": h}, True,
                                    aux_vals={}, rng=(0, 0))"""),
    ("""    def loss(params, x, y):
        logp = jax.nn.log_softmax(compose(params, x), axis=-1)
        lab = jnp.asarray(y).astype(jnp.int32)
        return -jnp.mean(jnp.take_along_axis(
            logp, lab[..., None], axis=-1))

    ref = {k: jnp.asarray(v) for k, v in init_host.items()}
    gfn = jax.jit(jax.grad(loss))""",
     """    def loss(params, x, y):
        logp = torch.log_softmax(compose(params, x), dim=-1)
        lab = torch.as_tensor(y).long()
        return -torch.mean(torch.gather(logp, -1, lab[..., None]))

    ref = {k: torch.as_tensor(v) for k, v in init_host.items()}

    def gfn(params, x, y):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        grads = torch.autograd.grad(loss(leaves, x, y),
                                    list(leaves.values()))
        return {k: g.detach() for k, g in zip(leaves, grads)}"""),
    ("""        h = jnp.asarray(x)
        for s, ex in enumerate(execs):""",
     """        h = torch.as_tensor(x)
        for s, ex in enumerate(execs):"""),
    ("""    import jax.numpy as jnp

    ex1, ex2 = pm._stage_execs[0], pm._stage_execs[1]""",
     """    import torch as jnp

    ex1, ex2 = pm._stage_execs[0], pm._stage_execs[1]"""),
    ("""        _, upd = ex2._run_graph(
            {**args2, "data": h}, auxs, jax.random.PRNGKey(0), True)""",
     """        _, upd = ex2._run_graph({**args2, "data": h}, True,
                                aux_vals=auxs, rng=(0, 0))"""),
]}
REPLAYED_FILES = ("test_sharding.py", "test_module_mesh.py",
                  "test_checkpoint_sharded.py", "test_model_parallel.py")


@pytest.fixture(autouse=True, scope="module")
def _eight_host_devices():
    """The port's host counts 8 devices here, as the JAX package's
    virtual CPU mesh does (`cpu(0..7)` all name the one host device)."""
    from mxnet_tpu_torch.parallel import mesh as tmesh

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmesh, "_count_local", lambda: 8)
        yield


def _cases():
    out = []
    for f in REPLAYED_FILES:
        src = open(os.path.join(os.path.dirname(__file__), f)).read()
        for line in src.splitlines():
            if line.startswith("def test_"):
                name = line[4:line.index("(")]
                if f"{f}::{name}" not in NOT_REPLAYED:
                    out.append(f"{f}::{name}")
    return out


_NS = {}


def _replay(f):
    """`replay(f)` with the file's ADAPT replacements made first."""
    if f not in ADAPT:
        return replay(f)
    from test_torch_ndarray import ROOT

    path = ROOT / "tests" / f
    src = path.read_text()
    for old, new in ADAPT[f]:
        assert old in src, (f, old)
        src = src.replace(old, new)
    src = src.replace("mxnet_tpu", "mxnet_tpu_torch")
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path),
          "torch": torch}
    exec(compile(src, str(path), "exec"), ns)
    return ns


@pytest.mark.parametrize("case", _cases())
def test_replayed(case, request, tmp_path):
    f, name = case.split("::")
    if f not in _NS:
        _NS[f] = _replay(f)
    fn = _NS[f][name]
    kw = {}
    params = inspect.signature(fn).parameters
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path
    if "monkeypatch" in params:
        kw["monkeypatch"] = request.getfixturevalue("monkeypatch")
    # the reference tests draw their initial weights (Xavier) from numpy's
    # global RandomState, whose state is whatever earlier tests in the
    # process left: test_pipeline_module_trains's loss does not fall in
    # 5 steps from 7 of 400 such states, in the JAX package as in the
    # port (test_pipeline_losses_equal_the_jax_package_at_any_rng_state).
    # Each replay runs from one fixed state, and the process's state is
    # put back after it.
    state = np.random.get_state()
    np.random.seed(REPLAY_NP_SEED)
    try:
        with tmx.cpu():
            fn(**kw)
    finally:
        np.random.set_state(state)


def _pipeline_losses(mx, seed):
    """test_module_mesh.py::test_pipeline_module_trains's 5 steps from
    numpy's global RandomState seeded with `seed`: the losses."""
    np.random.seed(seed)
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(d, num_hidden=8, flatten=False,
                              no_bias=True, name="fc")
    stage = mx.sym.Activation(h, act_type="tanh", name="act")
    pm = mx.mod.PipelineModule(stage, num_stages=4, num_microbatches=8,
                               context=mx.cpu())
    pm.bind(data_shapes=[("data", (16, 2, 8))])
    pm.init_params(mx.initializer.Xavier())
    pm.init_optimizer(optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.1),))
    rs = np.random.RandomState(0)
    losses = []
    for _ in range(5):
        b = mx.io.DataBatch(
            data=[mx.nd.array(rs.rand(16, 2, 8).astype("float32"))],
            label=[mx.nd.array(np.zeros((16, 2, 8), "float32"))])
        pm.forward_backward(b)
        pm.update()
        losses.append(float(pm.loss_value))
    return losses


@pytest.mark.parametrize("seed", [REPLAY_NP_SEED, 45, 60])
def test_pipeline_losses_equal_the_jax_package_at_any_rng_state(seed):
    """From the global RandomState states where the reference's
    test_pipeline_module_trains fails (45 and 60: its loss does not
    fall), the port's five losses are the JAX package's, so the replay's
    fixed state hides no fault of the port."""
    state = np.random.get_state()
    try:
        j = _pipeline_losses(jmx, seed)
        with tmx.cpu():
            t = _pipeline_losses(tmx, seed)
    finally:
        np.random.set_state(state)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
    assert (t[-1] < t[0]) == (seed == REPLAY_NP_SEED)


def test_not_replayed_names_exist():
    for key in NOT_REPLAYED:
        f, name = key.split("::")
        src = open(os.path.join(os.path.dirname(__file__), f)).read()
        assert f"def {name}(" in src, key


# --------------------------------------------------------- plans, digests
def _plans(pkg):
    sh = pkg.sharding
    return [
        sh.ShardingPlan({"data": 8}),
        sh.ShardingPlan({"data": 2, "fsdp": 2, "tp": 2}),
        sh.ShardingPlan({"data": 2, "tp": 4}, overrides={
            "w": "tp,None", "*_bias": "fsdp"}),
        sh.ShardingPlan({"fsdp": 4}, constrain_compute=False),
        sh.ShardingPlan({"tp": 2}, layout=sh.SpecLayout(tp_axis="model")),
    ]


SHAPES = {"tok_embed_weight": (64, 16), "l0_qkv_weight": (48, 16),
          "l0_attn_out_weight": (16, 16), "l0_ffn_w1_weight": (32, 16),
          "l0_ffn_w2_weight": (16, 32), "ln_gamma": (16,), "fc_bias": (3,),
          "w": (8, 6), "other": (5, 4)}


def test_plan_digests_and_resolution_equal_the_jax_package():
    from mxnet_tpu_torch.sharding import rules_digest, spec_to_str

    for jp, tp in zip(_plans(jmx), _plans(tmx)):
        assert tp.digest() == jp.digest()
        assert rules_digest(tp.layout, tp.overrides) == \
            jmx.sharding.rules_digest(jp.layout, jp.overrides)
        js, ts = jp.resolve(SHAPES), tp.resolve(SHAPES)
        assert {n: spec_to_str(s) for n, s in ts.items()} == \
            {n: jmx.sharding.spec_to_str(s) for n, s in js.items()}
        assert tp.describe(SHAPES) == jp.describe(SHAPES)
        assert tp.batch_axes() == jp.batch_axes()
        assert tuple(tp.input_spec("data", ndim=3)) == \
            tuple(jp.input_spec("data", ndim=3))
        assert repr(tp) == repr(jp)


def _toy_fit(pkg, plan=None, n_steps=3):
    """tests/test_sharding.py's dyadic toy in either package."""
    mx = pkg
    rng = np.random.RandomState(0)
    X = rng.randint(-1, 2, size=(8, 4)).astype(np.float32) / 2.0
    Y = rng.randint(-1, 2, size=(8, 8)).astype(np.float32) / 2.0
    it = mx.io.NDArrayIter(X, Y, batch_size=8, label_name="lro_label")
    data = mx.symbol.Variable("data")
    fc = mx.symbol.FullyConnected(data, name="out_head", num_hidden=8,
                                  no_bias=True)
    net = mx.symbol.LinearRegressionOutput(fc, name="lro")
    mod = mx.mod.Module(net, data_names=("data",),
                        label_names=("lro_label",), context=mx.cpu(),
                        sharding=plan)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    w0 = np.random.RandomState(7).randint(
        -1, 2, size=(8, 4)).astype(np.float32) / 2.0
    mod.init_params(arg_params={"out_head_weight": mx.nd.array(
        w0, ctx=mx.cpu())}, aux_params={}, force_init=True)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    for _ in range(n_steps):
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_dp_tp_fsdp_parity_and_specs():
    """test_dp_tp_fsdp_parity_and_storage's one-process half: the 2x2x2
    plan trains bit for bit as the JAX package's unsharded run, with
    the JAX package's spec and gather set (its storage half needs
    processes: tests/test_torch_dist.py)."""
    _, base = _toy_fit(jmx)
    mod, full = _toy_fit(tmx, tmx.ShardingPlan({"data": 2, "fsdp": 2,
                                                "tp": 2}))
    for name in base:
        np.testing.assert_array_equal(full[name], base[name])
    fs = mod._fused_step
    assert fs is not None and fs._mesh is not None and fs._mesh.size == 8
    w = fs.params["out_head_weight"]
    assert w.sharding.spec == ("tp", "fsdp")
    from mxnet_tpu_torch.sharding.lower import gather_shardings

    assert "out_head_weight" in gather_shardings(fs._plan, fs._param_specs)
    assert fs._profiling_digest().endswith(fs._plan.digest()[:8])


# ------------------------------------------------------------- attention
def _qkv(b=2, t=64, h=4, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl,seq,heads", [("ring", 8, 4),
                                            ("ulysses", 4, 8)])
def test_sequence_parallel_attention_matches_jax(impl, seq, heads, causal):
    from mxnet_tpu.parallel import attention_reference as jref
    from mxnet_tpu.parallel import make_mesh as jmesh
    from mxnet_tpu.parallel import ring_attention as jring
    from mxnet_tpu.parallel import ulysses_attention as july
    from mxnet_tpu_torch.parallel import make_mesh, ring_attention
    from mxnet_tpu_torch.parallel import ulysses_attention

    q, k, v = _qkv(t=32 if impl == "ulysses" else 64, h=heads)
    jfn, tfn = (jring, ring_attention) if impl == "ring" \
        else (july, ulysses_attention)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jfn(jq, jk, jv, mesh=jmesh({"seq": seq}),
                          causal=causal))
    dense = np.asarray(jref(jq, jk, jv, causal=causal))
    tq, tk, tv = (torch.tensor(a).requires_grad_(True) for a in (q, k, v))
    got = tfn(tq, tk, tv, mesh=make_mesh({"seq": seq}), causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               rtol=RING_TOL[0], atol=RING_TOL[1])
    np.testing.assert_allclose(got.detach().numpy(), dense,
                               rtol=RING_TOL[0], atol=RING_TOL[1])
    got.sum().backward()
    grads = jax.grad(lambda a, b, c: jfn(
        a, b, c, mesh=jmesh({"seq": seq}), causal=causal).sum(),
        argnums=(0, 1, 2))(jq, jk, jv)
    for x, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL[0], atol=GRAD_TOL[1])


def test_ulysses_rejects_bad_heads():
    from mxnet_tpu_torch.parallel import make_mesh, ulysses_attention

    q, k, v = (torch.tensor(a) for a in _qkv(t=32, h=4))
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, k, v, mesh=make_mesh({"seq": 8}))


def test_ring_op_reads_the_ambient_mesh():
    """RingAttention under use_mesh runs the ring (its shards' float32
    online softmax), not _plain_attention, as the JAX op does."""
    from mxnet_tpu_torch.ops.parallel_ops import (_plain_attention,
                                                  ring_attention_op)
    from mxnet_tpu_torch.parallel import mesh as tmesh

    q, k, v = (torch.tensor(a) for a in _qkv())
    plain = ring_attention_op(q, k, v, causal=True)
    assert torch.equal(plain, _plain_attention(q, k, v, True, 0.25))
    with tmesh.use_mesh(tmesh.make_mesh({"data": 1, "seq": 8})):
        ring = ring_attention_op(q, k, v, causal=True)
    assert not torch.equal(ring, plain)
    np.testing.assert_allclose(ring.numpy(), plain.numpy(),
                               rtol=RING_TOL[0], atol=RING_TOL[1])


# -------------------------------------------------------------- module
def _tower(pkg, mesh):
    from importlib import import_module

    get_transformer = import_module(pkg.__name__ + ".models") \
        .get_transformer
    d_model, heads, d_ff, b, t = 8, 2, 16, 4, 8
    net = get_transformer(d_model=d_model, num_heads=heads, d_ff=d_ff,
                          num_layers=2, causal=True,
                          tp_axis="seq" if mesh else None)
    kw = dict(mesh_shape={"data": 2, "seq": 4},
              data_shardings={"data": "data,seq", "label": "data,seq"}) \
        if mesh else {}
    mod = pkg.mod.Module(net, label_names=("label",),
                         context=[pkg.cpu()], **kw)
    mod.bind(data_shapes=[("data", (b, t, d_model))],
             label_shapes=[("label", (b, t, d_model))])
    rs = np.random.RandomState(4)
    init = {n: (rs.standard_normal(s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), net.infer_shape(
                data=(b, t, d_model), label=(b, t, d_model))[0])
            if n not in ("data", "label")}
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                                for n, v in init.items()},
                    aux_params={}, force_init=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9)))
    rs = np.random.RandomState(7)
    for _ in range(3):
        x, y = (rs.uniform(-1, 1, (b, t, d_model)).astype("float32")
                for _ in range(2))
        mod.forward_backward(pkg.io.DataBatch(
            data=[pkg.nd.array(x, ctx=pkg.cpu())],
            label=[pkg.nd.array(y, ctx=pkg.cpu())]))
        mod.update()
    return mod


def test_sp_tp_tower_matches_jax_after_three_steps():
    jm, tm = _tower(jmx, True), _tower(tmx, True)
    fs = tm._fused_step
    assert tuple(fs._param_specs["layer0_ffn_w1_weight"]) == ("seq", None)
    assert fs._mesh.size == 8 and fs._mesh.process_count == 1
    jp, tp = jm.get_params()[0], tm.get_params()[0]
    for k in jp:
        np.testing.assert_allclose(tp[k].asnumpy(), jp[k].asnumpy(),
                                   rtol=STEP_TOL[0], atol=STEP_TOL[1],
                                   err_msg=k)
    np.testing.assert_allclose(tm.get_outputs()[0].asnumpy(),
                               jm.get_outputs()[0].asnumpy(),
                               rtol=STEP_TOL[0], atol=STEP_TOL[1])


def test_mesh_axes_still_refused():
    """Only an axis the JAX package does not name is refused: the pipe
    and expert axes (refused until the second part of A.9) build the
    fused step's mesh."""
    net = tmx.models.get_mlp(num_classes=5, hidden=(16, 8))
    for shape in ({"data": 2, "pipe": 2}, {"expert": 2}):
        mod = tmx.mod.Module(net, context=tmx.cpu(), mesh_shape=shape)
        mod.bind(data_shapes=[("data", (4, 20))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        mod.init_optimizer()
        assert dict(mod._fused_step._mesh.shape) == shape
    with pytest.raises(tmx.MXNetError, match="not mesh axes"):
        tmx.mod.Module(net, context=tmx.cpu(), mesh_shape={"rows": 2})


def test_sharded_sentinel_rows_across_shardings():
    """tests/test_numerics.py's sharded parity on the port: the rows of
    the 2x2x2 plan against the unsharded JAX run's."""
    from mxnet_tpu.numerics import NumericsMonitor as JMon
    from mxnet_tpu_torch.numerics import NumericsMonitor as TMon

    def rows(pkg, mon_cls, plan):
        mod, _ = _toy_fit(pkg, plan, n_steps=0)
        mon = mon_cls(interval=0)
        mon.attach(mod)
        rng = np.random.RandomState(0)
        X = rng.randint(-1, 2, size=(8, 4)).astype(np.float32) / 2.0
        Y = rng.randint(-1, 2, size=(8, 8)).astype(np.float32) / 2.0
        for _ in range(3):
            mod.forward_backward(pkg.io.DataBatch(
                data=[pkg.nd.array(X, ctx=pkg.cpu())],
                label=[pkg.nd.array(Y, ctx=pkg.cpu())]))
            mod.update()
        mon.drain(mod)
        return list(mon.history)

    base = rows(jmx, JMon, None)
    shard = rows(tmx, TMon, tmx.ShardingPlan({"data": 2, "fsdp": 2,
                                              "tp": 2}))
    assert len(base) == len(shard) == 3
    for a, b in zip(base, shard):
        assert a["step"] == b["step"]
        assert a["out_nonfinite"] == b["out_nonfinite"] == 0.0
        ga, gb = a["groups"]["out_head"], b["groups"]["out_head"]
        assert ga["grad_max_abs"] == gb["grad_max_abs"]
        for key in ("loss", "grad_norm", "param_norm", "update_norm",
                    "update_ratio"):
            assert b[key] == pytest.approx(a[key], rel=1e-6), key


# ------------------------------------------------------------ decoding
def test_seq_mesh_for_divisibility():
    from mxnet_tpu_torch.parallel.ring_attention import seq_mesh_for

    mesh = seq_mesh_for(16)
    assert 16 % mesh.shape["seq"] == 0 and mesh.shape["seq"] > 1
    assert seq_mesh_for(7).shape["seq"] == 7   # 7 of 8 devices divide
    assert seq_mesh_for(13).shape["seq"] == 1  # prime > devices: degrade
    assert seq_mesh_for(16, max_devices=2).shape["seq"] == 2


def test_ring_prefill_long_prompt():
    """A prompt whose bucket reaches ring_prefill prefills through ring
    attention over the 8-entry host mesh; its greedy tokens equal the
    JAX package's dense reference."""
    from mxnet_tpu import decoding as jdec
    from mxnet_tpu_torch import decoding as tdec

    kw = dict(vocab=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
              max_len=64)
    jcfg, tcfg = jdec.DecoderConfig(**kw), tdec.DecoderConfig(**kw)
    params = tdec.init_decoder_params(tcfg, seed=0)
    jparams = jdec.init_decoder_params(jcfg, seed=0)
    m = tdec.DecodedModel("lm", 1, params, tcfg, device="cpu",
                          max_batch=2, page_size=4, num_pages=32,
                          page_buckets=(1, 2, 4), max_tokens=8,
                          ring_prefill=16)
    try:
        prompt = list(range(2, 14))   # buckets to 16 -> ring path
        out = m.generate(prompt, max_new_tokens=4, timeout=120)
        fn = m.engine._ring_fns[16]
        assert fn.mesh.shape["seq"] == 8
    finally:
        m.close()
    toks, want = list(prompt), []
    for _ in range(4):
        lg = jdec.reference_logits(jparams, np.asarray([toks], np.int32),
                                   jcfg)
        nxt = int(jnp.argmax(lg[0, -1]))
        if nxt == jcfg.eos_id:
            break
        want.append(nxt)
        toks.append(nxt)
    assert out == want
