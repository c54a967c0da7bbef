"""A worker of the two-process runs of tests/test_torch_dist.py, on the
CPU. tools/launch.py starts two of them:

    python tools/launch.py -n 2 python tests/torch_dist_worker.py MODE OUT

MODE is `sync` (KVStore dist_sync), `async` (dist_async, then rank 1
dies and rank 0 counts it dead), `fused` (the fused step's data plane
with run_steps, over a net with a BatchNorm), `pp` (pipelines and
experts: the nightly's 8-stage pipeline, 4 stages a worker; the MoE
tower on {'data': 2} with tokens dropped and on {'expert': 2}; a tied
LM pipeline with a BatchNorm whose tied stages sit on different ranks;
a pipeline whose boundary carries two tensors)
or `mp` (model parallelism
over a mesh of the two processes: ring and Ulysses attention on
sequence shards and on whole arrays, the SP+TP transformer tower on mesh
{'seq': 2} with a sharded checkpoint saved, resumed and written for the
test to load, the tower on that mesh with its inputs whole (no
data_shardings) and with the batch split over 'seq', and the dyadic toy
of tests/test_sharding.py under ShardingPlan {'fsdp': 2} and {'tp': 2}
with the numerics sentinel). Each rank writes what it saw to
OUT/<mode>-<rank>.npz; the test holds it against the JAX package's
single-process computation. The worker imports the port only.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402

SHAPE = (3, 4)
# the fused run: local rows a worker, steps before run_steps, run_steps k
LOCAL, STEPS, K = 8, 2, 3
IMAGE = (3, 6, 6)


def sync_values(rank):
    """The values rank `rank` inits and pushes, keyed by store key."""
    rs = np.random.RandomState(100 + rank)
    return {
        "init": {k: rs.randn(*SHAPE).astype(np.float32)
                 for k in ("a", "b", 3)},
        # two device copies of key "a", one of "b", then key 3 with the
        # SGD updater on the store
        "a": [rs.randn(*SHAPE).astype(np.float32) for _ in range(2)],
        "b": rs.randn(*SHAPE).astype(np.float32),
        "g3": rs.randn(*SHAPE).astype(np.float32),
    }


def run_sync(out):
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    vals = sync_values(rank)
    nd = lambda a: mx.nd.array(a, ctx=mx.cpu())  # noqa: E731
    kv.init(["a", "b"], [nd(vals["init"]["a"]), nd(vals["init"]["b"])])
    pulled_init = mx.nd.zeros(SHAPE, ctx=mx.cpu())
    kv.pull("a", out=pulled_init)
    kv.push(["a", "b"], [[nd(v) for v in vals["a"]], nd(vals["b"])])
    a, b = (mx.nd.zeros(SHAPE, ctx=mx.cpu()) for _ in range(2))
    kv.pull(["a", "b"], out=[a, b])
    kv2 = mx.kv.create("dist_sync")
    kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5,
                                          rescale_grad=0.25))
    kv2.init(3, nd(vals["init"][3]))
    kv2.push(3, nd(vals["g3"]))
    w3 = mx.nd.zeros(SHAPE, ctx=mx.cpu())
    kv2.pull(3, out=w3)
    # a global array split over the two processes' data axis
    from mxnet_tpu_torch.parallel import mesh

    value = np.arange(24, dtype=np.float32).reshape(4, 6)
    placed = mesh.global_put(value, mesh.batch_sharded(
        mesh.data_parallel_mesh()))
    kv._barrier()
    np.savez(os.path.join(out, f"sync-{rank}.npz"),
             num_workers=kv.num_workers, init=pulled_init.asnumpy(),
             a=a.asnumpy(), b=b.asnumpy(), w3=w3.asnumpy(),
             dead=kv.get_num_dead_node(timeout=60),
             local_rows=placed.local.numpy(), full=mesh.full_host(placed))


def async_grads(rank):
    rs = np.random.RandomState(200 + rank)
    return [rs.randn(*SHAPE).astype(np.float32) for _ in range(3)]


def run_async(out):
    kv = mx.kv.create("dist_async")
    rank = kv.rank
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
    # rank-dependent init: the server's (rank 0's) wins
    kv.init("w", mx.nd.array(np.full(SHAPE, float(rank + 1), np.float32),
                             ctx=mx.cpu()))
    for g in async_grads(rank):
        kv.push("w", mx.nd.array(g, ctx=mx.cpu()))
    kv._barrier()
    alive = kv.get_num_dead_node(timeout=30)
    if rank == 1:
        np.savez(os.path.join(out, "async-1.npz"), alive=alive)
        sys.stdout.flush()
        os._exit(0)     # dies without a word to the group
    deadline = time.time() + 30
    while kv._applied < 2 * len(async_grads(0)) and time.time() < deadline:
        time.sleep(0.01)
    w = mx.nd.zeros(SHAPE, ctx=mx.cpu())
    kv.pull("w", out=w)
    dead = 0
    deadline = time.time() + 40
    while dead < 1 and time.time() < deadline:
        dead = kv.get_num_dead_node(timeout=4)
        time.sleep(0.5)
    np.savez(os.path.join(out, "async-0.npz"), alive=alive, dead=dead,
             w=w.asnumpy(), applied=kv._applied)
    sys.stdout.flush()
    os._exit(0)     # a clean shutdown would wait on the dead peer


def fused_net(mx):
    """A conv with a BatchNorm, then a dense head: the global batch's
    statistics are tested."""
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, num_filter=4, kernel=(3, 3), name="conv")
    bn = mx.sym.BatchNorm(c, fix_gamma=False, name="bn")
    a = mx.sym.Activation(bn, act_type="relu", name="relu")
    f = mx.sym.FullyConnected(mx.sym.Flatten(a), num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(f, name="softmax")


def fused_batches():
    """(x, y) of every step's global batch: STEPS single steps, then K
    stacked."""
    rs = np.random.RandomState(7)
    n = STEPS + K
    x = rs.uniform(-1, 1, (n, 2 * LOCAL) + IMAGE).astype(np.float32)
    y = rs.randint(0, 5, (n, 2 * LOCAL)).astype(np.float32)
    return x, y


def fused_init(rank):
    """Rank-dependent initial parameters (the step's broadcast makes rank
    0's the lineage)."""
    mod = mx.mod.Module(fused_net(mx), context=mx.cpu())
    mod.bind(data_shapes=[("data", (LOCAL,) + IMAGE)],
             label_shapes=[("softmax_label", (LOCAL,))])
    mx.random.seed(rank)
    np.random.seed(rank)
    mod.init_params(mx.init.Xavier(magnitude=2 + rank))
    return mod


def run_fused(out):
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    mod = fused_init(rank)
    args, auxs = mod.get_params()
    init = {f"arg:{k}": v.asnumpy() for k, v in args.items()}
    init.update({f"aux:{k}": v.asnumpy() for k, v in auxs.items()})
    mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9)))
    fs = mod._fused_step
    assert fs is not None and fs._nproc == 2 and fs._batch_scale == 2
    rows = slice(rank * LOCAL, (rank + 1) * LOCAL)
    x, y = fused_batches()
    nd = lambda a: mx.nd.array(a, ctx=mx.cpu())  # noqa: E731
    for i in range(STEPS):
        mod.forward_backward(mx.io.DataBatch(data=[nd(x[i, rows])],
                                             label=[nd(y[i, rows])]))
        mod.update()
    first_outs = mod.get_outputs()[0].asnumpy()
    mod.run_steps(mx.io.DataBatch(data=[nd(x[STEPS:, rows])],
                                  label=[nd(y[STEPS:, rows])]),
                  K, stacked=True)
    outs = mod.get_outputs()[0].asnumpy()
    args, auxs = mod.get_params()
    res = {f"arg:{k}": v.asnumpy() for k, v in args.items()}
    res.update({f"aux:{k}": v.asnumpy() for k, v in auxs.items()})
    # a partial batch whose rows the data axis divides stays fused; its
    # outputs are this worker's rows
    half = LOCAL // 2
    mod.forward(mx.io.DataBatch(data=[nd(x[0, rows][:half])],
                                label=[nd(y[0, rows][:half])]),
                is_train=True)
    staged = mod._staged_vals is not None
    mod.update()
    partial_rows = mod.get_outputs()[0].shape[0]
    kv._barrier()
    np.savez(os.path.join(out, f"fused-{rank}.npz"),
             **{f"init/{k}": v for k, v in init.items()},
             **{f"final/{k}": v for k, v in res.items()},
             first_outs=first_outs, outs=outs, staged=staged,
             partial_rows=partial_rows, t=fs._t,
             segments=np.asarray([f"{a}:{b}" for a, b in fs.segments()]))


# the mp run: the tower's size, its steps, the attention inputs' shape
TOWER = dict(d_model=8, num_heads=2, d_ff=16, num_layers=2, causal=True)
TB, TT, TOWER_STEPS = 4, 16, 3
QKV = (2, 16, 2, 8)


def attention_inputs():
    """q, k, v and the output weights of the attention check (global)."""
    rs = np.random.RandomState(3)
    return [rs.standard_normal(QKV).astype(np.float32) for _ in range(4)]


def tower_batches(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(-1, 1, (TB, TT, TOWER["d_model"])).astype(
                 np.float32),
             rs.uniform(-1, 1, (TB, TT, TOWER["d_model"])).astype(
                 np.float32)) for _ in range(n)]


def tower_init():
    """The tower's initial parameters (numpy-seeded, the same on every
    process and in the test)."""
    rs = np.random.RandomState(11)
    net = mx.models.get_transformer(tp_axis="seq", **TOWER)
    shapes, _, _ = net.infer_shape(data=(TB, TT, TOWER["d_model"]),
                                   label=(TB, TT, TOWER["d_model"]))
    return {n: (rs.standard_normal(sh) * 0.3).astype(np.float32)
            for n, sh in zip(net.list_arguments(), shapes)
            if n not in ("data", "label")}


def tower_module(mesh_shape=None, data_shardings=None):
    net = mx.models.get_transformer(
        tp_axis="seq" if mesh_shape else None, **TOWER)
    mod = mx.mod.Module(net, label_names=("label",), context=mx.cpu(),
                        mesh_shape=mesh_shape,
                        data_shardings=data_shardings)
    mod.bind(data_shapes=[("data", (TB, TT, TOWER["d_model"]))],
             label_shapes=[("label", (TB, TT, TOWER["d_model"]))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in tower_init().items()},
                    aux_params={}, force_init=True)
    mod.init_optimizer(kvstore="tpu" if mesh_shape else "local",
                       optimizer="sgd", optimizer_params=(
                           ("learning_rate", 0.1), ("momentum", 0.9)))
    return mod


def tower_steps(mod, batches):
    for x, y in batches:
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(x, ctx=mx.cpu())],
            label=[mx.nd.array(y, ctx=mx.cpu())]))
        mod.update()


SEQ = dict(mesh_shape={"seq": 2},
           data_shardings={"data": "None,seq", "label": "None,seq"})


def toy_data():
    """tests/test_sharding.py's dyadic recipe: (X, Y, w0)."""
    rng = np.random.RandomState(0)
    x = rng.randint(-1, 2, size=(8, 4)).astype(np.float32) / 2.0
    y = rng.randint(-1, 2, size=(8, 8)).astype(np.float32) / 2.0
    w0 = np.random.RandomState(7).randint(
        -1, 2, size=(8, 4)).astype(np.float32) / 2.0
    return x, y, w0


def toy_fit(plan):
    """3 SGD steps of the dyadic toy under `plan` with the sentinel on:
    (module, params, sentinel rows)."""
    from mxnet_tpu_torch.numerics import NumericsMonitor

    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, name="out_head", num_hidden=8,
                               no_bias=True)
    net = mx.sym.LinearRegressionOutput(fc, name="lro")
    x, y, w0 = toy_data()
    mod = mx.mod.Module(net, data_names=("data",),
                        label_names=("lro_label",), context=mx.cpu(),
                        sharding=plan)
    mod.bind(data_shapes=[("data", (8, 4))],
             label_shapes=[("lro_label", (8, 8))])
    mod.init_params(arg_params={"out_head_weight": mx.nd.array(
        w0, ctx=mx.cpu())}, aux_params={}, force_init=True)
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    mon = NumericsMonitor(interval=0)
    mon.attach(mod)
    for _ in range(3):
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(x, ctx=mx.cpu())],
            label=[mx.nd.array(y, ctx=mx.cpu())]))
        mod.update()
    mon.drain(mod)
    rows = np.asarray([[r["groups"]["out_head"]["grad_norm"],
                        r["groups"]["out_head"]["param_norm"],
                        r["groups"]["out_head"]["grad_max_abs"], r["loss"]]
                       for r in mon.history], np.float64)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, \
        rows


def run_mp(out):
    import torch

    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel.ring_attention import (
        ring_attention, split_inputs, ulysses_attention)
    from mxnet_tpu_torch.sharding import ShardingPlan, device_param_bytes

    kv = mx.kv.create("tpu")
    rank = kv.rank
    res = {}
    # ring and Ulysses attention over the two processes' 'seq' axis: on
    # this process's sequence shard, and on the whole (global) arrays
    mesh = tmesh.make_mesh({"seq": 2})
    q, k, v, w = attention_inputs()
    half = slice(rank * QKV[1] // 2, (rank + 1) * QKV[1] // 2)
    for impl, fn in (("ring", ring_attention),
                     ("ulysses", ulysses_attention)):
        t = [torch.tensor(a[:, half]).requires_grad_(True)
             for a in (q, k, v)]
        with split_inputs({"seq": 1}):
            o = fn(*t, mesh=mesh, causal=True)
        (o * torch.tensor(w[:, half])).sum().backward()
        res[f"{impl}/out"] = o.detach().numpy()
        for name, x in zip("qkv", t):
            res[f"{impl}/d{name}"] = x.grad.numpy()
        t = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
        o = fn(*t, mesh=mesh, causal=True)
        (o * torch.tensor(w)).sum().backward()
        res[f"{impl}/whole_out"] = o.detach().numpy()
        for name, x in zip("qkv", t):
            res[f"{impl}/whole_d{name}"] = x.grad.numpy()
    # the tower over mesh {'seq': 2} with its inputs whole (no
    # data_shardings) and with the batch split over the ring's axis
    for tag, spec in (("whole", None), ("rows", "seq")):
        m = tower_module(mesh_shape={"seq": 2}, data_shardings=spec and {
            "data": spec, "label": spec})
        tower_steps(m, tower_batches(TOWER_STEPS, seed=5))
        res.update({f"{tag}/{n}": a.asnumpy()
                    for n, a in m.get_params()[0].items()})
        res[f"{tag}/outs"] = m.get_outputs()[0].asnumpy()
    # the SP+TP tower: 2 steps, a sharded checkpoint, a third step
    batches = tower_batches(TOWER_STEPS, seed=5)
    mod = tower_module(**SEQ)
    fs = mod._fused_step
    tower_steps(mod, batches[:2])
    ck = os.path.join(out, "tower_ck")
    mx.save_sharded(mod, ck)
    res.update({f"ck/{n}": a.asnumpy()
                for n, a in mod.get_params()[0].items()})
    tower_steps(mod, batches[2:])
    res["tower/outs"] = mod.get_outputs()[0].asnumpy()
    res.update({f"tower/{n}": a.asnumpy()
                for n, a in mod.get_params()[0].items()})
    res["tower/local_w1"] = fs.params["layer0_ffn_w1_weight"].numpy()
    res["tower/stored_bytes"] = device_param_bytes(fs.params)
    res["tower/w_bytes"] = sum(
        device_param_bytes({n: fs.params[n]}) for n in fs.params
        if n.endswith(("_w1_weight", "_w2_weight")))
    res["tower/segments"] = np.asarray([f"{a}:{b}"
                                        for a, b in fs.segments()])
    res["tower/uncaptured"] = str(fs.uncaptured_op)
    # resumed from the checkpoint: the third step again
    resumed = tower_module(**SEQ)
    meta = mx.load_sharded(resumed, ck)
    tower_steps(resumed, batches[2:])
    res["resumed/t"] = meta["t"]
    res.update({f"resumed/{n}": a.asnumpy()
                for n, a in resumed.get_params()[0].items()})
    # the dyadic toy under fsdp and tp, with the sentinel
    for tag, axes in (("fsdp", {"fsdp": 2}), ("tp", {"tp": 2})):
        tmod, params, rows = toy_fit(ShardingPlan(axes))
        tfs = tmod._fused_step
        res[f"{tag}/w"] = params["out_head_weight"]
        res[f"{tag}/rows"] = rows
        res[f"{tag}/spec"] = str(tuple(tfs._param_specs["out_head_weight"]))
        res[f"{tag}/stored"] = device_param_bytes(tfs.params)
    kv._barrier()
    np.savez(os.path.join(out, f"mp-{rank}.npz"), **res)


# the pp run: the nightly's 8-stage pipeline (tests/nightly/
# dist_model_parallel.py run_pipeline), the MoE tower, the tied LM
PP_STAGES, PP_MICRO, PP_BATCH, PP_STEPS = 8, 16, 32, 2
MOE = dict(d_model=8, num_heads=2, d_ff=16, num_layers=2, causal=False,
           moe_every=2, num_experts=4, capacity_factor=0.5)
MB, MT, MOE_STEPS = 4, 8, 3      # each worker's rows on {'data': 2}
LM_VOCAB, LM_D, LM_B, LM_T, LM_STEPS = 11, 6, 8, 4, 3


def pp_stage(mx):
    d = mx.sym.Variable("data")
    return mx.sym.Activation(
        mx.sym.FullyConnected(d, num_hidden=8, flatten=False,
                              no_bias=True, name="fc"),
        act_type="tanh", name="act")


def pp_batches():
    rs = np.random.RandomState(3)
    return [(rs.rand(PP_BATCH, 2, 8).astype("float32"),
             np.zeros((PP_BATCH, 2, 8), "float32"))
            for _ in range(PP_STEPS)]


def pp_module(mx, ctx):
    pm = mx.mod.PipelineModule(pp_stage(mx), num_stages=PP_STAGES,
                               num_microbatches=PP_MICRO, context=ctx)
    pm.bind(data_shapes=[("data", (PP_BATCH, 2, 8))])
    np.random.seed(13)
    pm.init_params(mx.initializer.Xavier())
    pm.init_optimizer(optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.05),))
    return pm


def moe_net(mx):
    import importlib

    return importlib.import_module(f"{mx.__name__}.models") \
        .get_transformer(**MOE)


def moe_init(mx, batch):
    """The MoE tower's initial parameters (numpy-seeded)."""
    rs = np.random.RandomState(17)
    net = moe_net(mx)
    shapes, _, _ = net.infer_shape(data=(batch, MT, MOE["d_model"]),
                                   label=(batch, MT, MOE["d_model"]))
    return {n: (rs.standard_normal(sh) * 0.3).astype(np.float32)
            for n, sh in zip(net.list_arguments(), shapes)
            if n not in ("data", "label")}


def moe_batches(batch):
    rs = np.random.RandomState(23)
    return [(rs.uniform(-1, 1, (batch, MT, MOE["d_model"])).astype(
                 np.float32),
             rs.uniform(-1, 1, (batch, MT, MOE["d_model"])).astype(
                 np.float32)) for _ in range(MOE_STEPS)]


def moe_module(mx, ctx, batch, mesh_shape, kvstore):
    mod = mx.mod.Module(moe_net(mx), label_names=("label",), context=ctx,
                        mesh_shape=mesh_shape)
    mod.bind(data_shapes=[("data", (batch, MT, MOE["d_model"]))],
             label_shapes=[("label", (batch, MT, MOE["d_model"]))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx) for k, v in
                                moe_init(mx, batch).items()},
                    aux_params={}, force_init=True)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),))
    return mod


def tied_lm_stages(mx):
    """embedding -> FC + BatchNorm + tanh -> FC + tanh -> head, the head
    weight tied to the embedding table: over two processes the tied
    stages sit on different ranks."""
    v = lambda: mx.sym.Variable("data")  # noqa: E731
    emb = mx.sym.Embedding(v(), input_dim=LM_VOCAB, output_dim=LM_D,
                           name="emb")
    b1 = mx.sym.Activation(mx.sym.BatchNorm(mx.sym.FullyConnected(
        v(), num_hidden=LM_D, flatten=False, no_bias=True, name="b1fc"),
        name="bn"), act_type="tanh", name="b1act")
    b2 = mx.sym.Activation(mx.sym.FullyConnected(
        v(), num_hidden=LM_D, flatten=False, no_bias=True, name="b2fc"),
        act_type="tanh", name="b2act")
    head = mx.sym.FullyConnected(v(), num_hidden=LM_VOCAB, flatten=False,
                                 no_bias=True, name="head")
    return [emb, b1, b2, head]


TIES = [("stage0/emb_weight", "stage3/head_weight")]


def tied_batches():
    rs = np.random.RandomState(29)
    out = []
    for _ in range(LM_STEPS):
        x = rs.randint(0, LM_VOCAB, (LM_B, LM_T)).astype("float32")
        out.append((x, (x + 1) % LM_VOCAB))
    return out


def tied_module(mx, ctx):
    pm = mx.mod.PipelineModule(tied_lm_stages(mx), num_microbatches=4,
                               context=ctx, loss="softmax_ce",
                               tied_params=TIES)
    pm.bind(data_shapes=[("data", (LM_B, LM_T))])
    np.random.seed(31)
    pm.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                         magnitude=1.0))
    pm.init_optimizer(optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.5),))
    return pm


def multi_module(mx, ctx):
    """tests/test_pipeline_moe.py's multi-input boundary: stage 0 emits
    (tanh(fc(x)), x), stage 1 reads them as data and data1."""
    data = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(
        data, num_hidden=6, flatten=False, no_bias=True, name="s0fc"),
        act_type="tanh")
    s0 = mx.sym.Group([h, data])
    s1 = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=6,
                               flatten=False, no_bias=True, name="s1fc") \
        + mx.sym.Variable("data1")
    pm = mx.mod.PipelineModule([s0, s1], num_microbatches=4, context=ctx,
                               loss="l2")
    pm.bind(data_shapes=[("data", (8, 3, 6))])
    np.random.seed(9)
    pm.init_params(mx.initializer.Xavier())
    pm.init_optimizer(optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.3),))
    return pm


def multi_batches():
    rs = np.random.RandomState(5)
    out = []
    for _ in range(3):
        x = rs.standard_normal((8, 3, 6)).astype("float32")
        out.append((x, np.tanh(x)))
    return out


def pm_steps(mx, pm, batches, ctx):
    losses = []
    for x, y in batches:
        pm.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(x, ctx=ctx)], label=[mx.nd.array(y, ctx=ctx)]))
        pm.update()
        losses.append(pm.loss_value)
    return losses


def run_pp(out):
    from mxnet_tpu_torch.parallel import collective, moe

    kv = mx.kv.create("tpu")
    rank = kv.rank
    ctx = mx.cpu()
    res = {}
    # the nightly's pipeline: 8 stages, 4 a worker, every worker fed the
    # same batch
    pm = pp_module(mx, ctx)
    res["pp/local_stages"] = pm.params["fc_weight"].shape[0]
    res["pp/losses"] = pm_steps(mx, pm, pp_batches(), ctx)
    res["pp/outs"] = pm.get_outputs()[0].asnumpy()
    res.update({f"pp/{k}": v.asnumpy()
                for k, v in pm.get_params()[0].items()})
    # inference across the workers: no graph kept, no step taken
    pm.forward(mx.io.DataBatch(data=[mx.nd.array(pp_batches()[0][0],
                                                 ctx=ctx)], label=None),
               is_train=False)
    res["pp/infer"] = pm.get_outputs()[0].asnumpy()
    res["pp/t_after_infer"] = pm._t
    # the MoE tower on {'data': 2}: each worker its rows, the gating
    # global (capacity, queue positions and aux over both workers' rows)
    rows = slice(rank * MB, (rank + 1) * MB)
    moe.reset_stats()
    mod = moe_module(mx, ctx, MB, {"data": 2}, "tpu")
    fs = mod._fused_step
    for x, y in moe_batches(2 * MB):
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(x[rows], ctx=ctx)],
            label=[mx.nd.array(y[rows], ctx=ctx)]))
        mod.update()
    res["data/outs"] = mod.get_outputs()[0].asnumpy()
    res["data/aux"] = mod.get_outputs()[1].asnumpy()
    res.update({f"data/{k}": v.asnumpy()
                for k, v in mod.get_params()[0].items()})
    res["data/dropped"] = moe.stats()["dropped"]
    res["data/batch_scale"] = fs._batch_scale
    res["data/uncaptured"] = str(fs.uncaptured_op)
    # the MoE tower on {'expert': 2}: the whole batch on both workers,
    # each computing 2 of the 4 experts
    moe.reset_stats()
    collective.reset_sent_bytes()
    mod = moe_module(mx, ctx, 2 * MB, {"expert": 2}, "tpu")
    for x, y in moe_batches(2 * MB):
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(x, ctx=ctx)], label=[mx.nd.array(y, ctx=ctx)]))
        mod.update()
    res["expert/outs"] = mod.get_outputs()[0].asnumpy()
    res.update({f"expert/{k}": v.asnumpy()
                for k, v in mod.get_params()[0].items()})
    st = moe.stats()
    res["expert/computed"] = st["experts_computed"]
    res["expert/experts"] = st["experts"]
    res["expert/bytes"] = sum(collective.sent_bytes().values())
    # the tied LM over two workers: the tied stages on different ranks
    pm = tied_module(mx, ctx)
    res["tied/losses"] = pm_steps(mx, pm, tied_batches(), ctx)
    args, auxs = pm.get_params()
    res.update({f"tied/{k}": v.asnumpy() for k, v in args.items()})
    res.update({f"tied_aux/{k}": v.asnumpy() for k, v in auxs.items()})
    res["tied/local_rows"] = pm.params["pipeline_flat"].shape[0]
    res["tied/bound_stages"] = [s for s, ex in enumerate(pm._stage_execs)
                                if ex is not None]
    # two boundary tensors (data, data1) crossing between the workers
    pm = multi_module(mx, ctx)
    res["multi/losses"] = pm_steps(mx, pm, multi_batches(), ctx)
    res.update({f"multi/{k}": v.asnumpy()
                for k, v in pm.get_params()[0].items()})
    kv._barrier()
    np.savez(os.path.join(out, f"pp-{rank}.npz"), **res)


if __name__ == "__main__":
    mode, out = sys.argv[1], sys.argv[2]
    {"sync": run_sync, "async": run_async, "fused": run_fused,
     "mp": run_mp, "pp": run_pp}[mode](out)
