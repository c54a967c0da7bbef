"""The pipeline and the mixture of experts (the second part of the
model-parallel half of the multi-device slice) on one process, on the
CPU, against the JAX package on its 8 virtual CPU devices. The same
numpy-seeded inputs and parameters go through both packages; the port's
meshes over cpu(0..7) are one device's global program.

- tests/test_pipeline_moe.py's jax-level cases: `pipeline_apply` over
  {'pipe': 4} within 1e-6 with its gradients within 1e-5/1e-6;
  `top1_gating`'s dispatch and combine bit for bit, its aux within 1e-7
  (absolute and relative: its two means are summed in another order);
  one expert against the dense FFN; {'expert': 4} against no mesh;
  `moe_ffn`'s gradients within 1e-5/1e-6; `init_moe_params` bit for bit
  from the same key. `test_pipeline_under_jit`'s counterpart holds the
  same numbers through PipelineModule's step (the homogeneous parity).
- the index route of `moe_ffn` against the dense einsums
  (`moe_ffn_plain`) bit for bit on finite inputs, tokens dropped.
- the four mx-API cases of tests/test_pipeline_moe.py replayed.
- PipelineModule against the JAX package's after three steps from the
  JAX package's parameters (its stage-major leaves, `pipeline_flat` and
  aux bucket carried over whole): homogeneous (1e-5/1e-6), a
  heterogeneous LM with BatchNorm (parameters and moving statistics,
  2e-4/2e-5), the tied bfloat16 LM (5e-3 of each parameter's scale,
  bfloat16 compute; the tied copies bit-equal in both packages).
- the MoE transformer through Module on {'data': 2, 'expert': 4} at a
  capacity factor that drops tokens, after 3 SGD steps (2e-4/2e-5), and
  the MoEFFN op's two outputs and gradients against the JAX op.
- `init_moe_params` follows the current context; Inception-ResNet-v2's
  4 pipeline stages compose to the classifier's logits bit for bit.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.base as jbase  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
import mxnet_tpu_torch.base as tbase  # noqa: E402
from mxnet_tpu.parallel import moe as jmoe  # noqa: E402
from mxnet_tpu.parallel import pipeline as jpipe  # noqa: E402
from mxnet_tpu_torch.module.module import params_from_jax  # noqa: E402
from mxnet_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from mxnet_tpu_torch.parallel import moe as tmoe  # noqa: E402
from mxnet_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_ndarray import replay  # noqa: E402

PIPE_TOL = (1e-6, 1e-6)
GRAD_TOL = (1e-5, 1e-6)
STEP_TOL = (2e-4, 2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------- pipeline_apply
def test_pipeline_apply_matches_jax_with_gradients():
    s, m, d = 4, 6, 8
    rs = np.random.RandomState(0)
    ws = (rs.standard_normal((s, d, d)) * 0.5).astype(np.float32)
    mbs = rs.standard_normal((m, 2, d)).astype(np.float32)

    def jloss(w):
        out = jpipe.pipeline_apply(lambda p, x, i: jnp.tanh(x @ p), w,
                                   jnp.asarray(mbs),
                                   jmx.parallel.make_mesh({"pipe": s}))
        return jnp.sum(out ** 2), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(ws))
    w = _t(ws).requires_grad_(True)
    tout = tpipe.pipeline_apply(lambda p, x, i: torch.tanh(x @ p), w,
                                _t(mbs), tmesh.make_mesh({"pipe": s}))
    (tgrad,) = torch.autograd.grad((tout ** 2).sum(), w)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=PIPE_TOL[0], atol=PIPE_TOL[1])
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad),
                               rtol=GRAD_TOL[0], atol=GRAD_TOL[1])


def test_pipeline_apply_hetero_casts_boundaries_and_threads_aux():
    """Two stages, a bfloat16 boundary: the values go through float32 and
    back as the ring buffer takes them; each stage's aux counts its
    microbatches in order."""
    m = 3

    def stage(s, in_dt, out_dt):
        def fn(p, a, xs, mb):
            y = (xs[0].to(torch.float32) * p[0]).to(getattr(torch, out_dt))
            return (y,), a * 2 + mb
        fn.in_shapes, fn.out_shapes = [(2,)], [(2,)]
        fn.in_dtypes, fn.out_dtypes = [in_dt], [out_dt]
        return fn

    fns = [stage(0, "float32", "bfloat16"), stage(1, "bfloat16", "float32")]
    mbs = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    out, auxs = tpipe.pipeline_apply_hetero(
        fns, torch.tensor([[0.5], [3.0]]), torch.ones(2, 1), mbs,
        tmesh.make_mesh({"pipe": 2}))
    want = (mbs * 0.5).to(torch.bfloat16).to(torch.float32) * 3.0
    assert out.dtype == torch.float32 and torch.equal(out, want)
    # a <- 2a + mb for mb = 0, 1, 2 from 1: 2, 5, 12
    assert auxs.tolist() == [[12.0], [12.0]]
    assert auxs.shape == (2, 1) and out.shape == (m, 2)


# -------------------------------------------------------------------- MoE
def _logits_cases():
    rs = np.random.RandomState(4)
    ties = np.zeros((6, 3), np.float32)
    ties[1] = [2.0, 2.0, 1.0]
    return [
        (np.array([[10.0, 0.0], [10.0, 0.0], [10.0, 0.0], [0.0, 10.0]],
                  np.float32), 2, 2),
        ((rs.standard_normal((64, 8)) * 3).astype(np.float32), 8, 6),
        ((rs.standard_normal((200, 4)) * 0.3).astype(np.float32), 4, 40),
        (ties, 3, 2),
    ]


@pytest.mark.parametrize("case", range(4))
def test_top1_gating_bit_for_bit(case):
    logits, e, cap = _logits_cases()[case]
    jd, jc, ja = jmoe.top1_gating(jnp.asarray(logits), e, cap)
    td, tc, ta = tmoe.top1_gating(_t(logits), e, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the means are summed in another order: one float32 ulp at most
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-7, atol=1e-7)
    if case == 0:    # the reference's capacity case: the third dropped
        assert float(td[:, 0, :].sum()) == 2.0
        assert float(td[:, 1, :].sum()) == 1.0


def test_init_moe_params_bit_for_bit():
    for seed, (d, f, e) in ((0, (4, 16, 1)), (1, (8, 16, 4)),
                            (2, (4, 8, 2))):
        want = jmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, e)
        got = tmoe.init_moe_params((0, seed), d, f, e, device="cpu")
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


def test_init_moe_params_follows_the_current_context():
    """No device named: the current context's device (the card by
    default, the host inside `with cpu()`)."""
    with tmx.cpu(1):
        got = tmoe.init_moe_params((0, 5), 4, 8, 2)
    want = tmoe.init_moe_params((0, 5), 4, 8, 2, device="cpu")
    for k, v in got.items():
        assert v.device.type == "cpu", k
        assert torch.equal(v, want[k]), k


def _moe_inputs(seed, t, d, f, e):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((t, d)).astype(np.float32)
    p = {k: np.asarray(v) for k, v in
         jmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, e).items()}
    return x, p


def test_moe_ffn_single_expert_is_the_dense_ffn():
    x, p = _moe_inputs(1, 8, 4, 16, 1)
    out, _aux = tmoe.moe_ffn(_t(x), _t(p["router_w"]), _t(p["w1"]),
                             _t(p["w2"]), capacity_factor=2.0)
    ref = torch.relu(_t(x) @ _t(p["w1"][0])) @ _t(p["w2"][0])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    jout, _ = jmoe.moe_ffn(jnp.asarray(x), p["router_w"], p["w1"], p["w2"],
                           capacity_factor=2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_ffn_index_route_is_the_dense_einsums(cf):
    """Bit for bit on finite inputs; at 0.5 tokens are dropped."""
    x, p = _moe_inputs(5, 48, 8, 16, 4)
    args = (_t(x), _t(p["router_w"]), _t(p["w1"]), _t(p["w2"]))
    tmoe.reset_stats()
    out, aux = tmoe.moe_ffn(*args, capacity_factor=cf)
    dropped = tmoe.stats()["dropped"]
    pout, paux = tmoe.moe_ffn_plain(*args, capacity_factor=cf)
    np.testing.assert_array_equal(out.numpy(), pout.numpy())
    assert float(aux) == float(paux)
    assert (dropped > 0) == (cf < 1.0), dropped


def test_moe_expert_mesh_matches_local_and_jax():
    x, p = _moe_inputs(2, 16, 8, 16, 4)
    args = (_t(x), _t(p["router_w"]), _t(p["w1"]), _t(p["w2"]))
    local, aux_l = tmoe.moe_ffn(*args, capacity_factor=2.0)
    mesh = tmesh.make_mesh({"expert": 4})
    ep, aux_e = tmoe.moe_ffn(*args, capacity_factor=2.0, mesh=mesh,
                             axis_name="expert")
    np.testing.assert_array_equal(ep.numpy(), local.numpy())
    assert float(aux_e) == float(aux_l)
    jmesh = jmx.parallel.make_mesh({"expert": 4})
    jep, jaux = jax.jit(lambda x, q: jmoe.moe_ffn(
        x, q["router_w"], q["w1"], q["w2"], capacity_factor=2.0,
        mesh=jmesh, axis_name="expert"))(jnp.asarray(x), p)
    np.testing.assert_allclose(ep.numpy(), np.asarray(jep), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_e), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("cf", [2.0, 0.75])
def test_moe_ffn_gradients_match_jax(cf):
    x, p = _moe_inputs(3, 8, 4, 8, 2)

    def jloss(q, xx):
        out, aux = jmoe.moe_ffn(xx, q["router_w"], q["w1"], q["w2"],
                                capacity_factor=cf)
        return jnp.mean(out ** 2) + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    leaves = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    xt = _t(x).requires_grad_(True)
    out, aux = tmoe.moe_ffn(xt, leaves["router_w"], leaves["w1"],
                            leaves["w2"], capacity_factor=cf)
    grads = torch.autograd.grad((out ** 2).mean() + 0.01 * aux,
                                list(leaves.values()) + [xt])
    for (k, g) in zip(list(leaves) + ["x"], grads):
        want = jgx if k == "x" else jg[k]
        assert np.abs(g.numpy()).sum() > 0, k
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL[0], atol=GRAD_TOL[1],
                                   err_msg=k)


def test_moeffn_op_matches_the_jax_op():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    x, p = _moe_inputs(6, 24, 8, 16, 4)
    x = x.reshape(2, 12, 8)
    kw = {"num_experts": 4, "hidden_size": 16, "capacity_factor": 0.5}
    jop, top = jreg.get("MoEFFN"), treg.get("moe_ffn")
    ins = [x, p["router_w"], p["w1"], p["w2"]]
    jo, ja = jop.fn(*[jnp.asarray(a) for a in ins],
                    **jop.normalize_params(kw))
    leaves = [_t(a).requires_grad_(True) for a in ins]
    to, ta = top.fn(*leaves, **top.normalize_params(kw))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ta.detach()), float(ja), rtol=0,
                               atol=1e-7)
    hg = np.random.RandomState(0).standard_normal(x.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: jop.fn(*a, **jop.normalize_params(kw)),
                     *[jnp.asarray(a) for a in ins])
    jg = vjp((jnp.asarray(hg), jnp.asarray(0.5, jnp.float32)))
    tg = torch.autograd.grad([to, ta], leaves,
                             [_t(hg), torch.tensor(0.5)])
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # symbolic shapes: the JAX package's rule
    tbase._name_counters.clear()
    s = tmx.sym.MoEFFN(tmx.sym.Variable("data"), num_experts=4,
                       hidden_size=16, name="moe")
    args, outs, _ = s.infer_shape(data=(2, 12, 8))
    assert args == [(2, 12, 8), (8, 4), (4, 8, 16), (4, 16, 8)]
    assert outs == [(2, 12, 8), ()]


# ------------------------------------------------------ the mx-API cases
MX_CASES = ["test_pipeline_bf16_tied_embedding_matches_single_device",
            "test_pipeline_per_name_lr_mult",
            "test_pipeline_multi_input_boundary",
            "test_pipeline_mixed_wd_mult"]
_NS = {}


@pytest.mark.parametrize("name", MX_CASES)
def test_replayed_mx_api_case(name):
    if "ns" not in _NS:
        _NS["ns"] = replay("test_pipeline_moe.py")
    with tmx.cpu():
        _NS["ns"][name]()


# ------------------------------------------------ PipelineModule parity
def _fit(pkg, pm, batches):
    """A step a batch: the losses, the outputs of the last step and the
    parameters after each step."""
    losses, params = [], []
    for x, y in batches:
        pm.forward_backward(pkg.io.DataBatch(data=[pkg.nd.array(x)],
                                             label=[pkg.nd.array(y)]))
        pm.update()
        losses.append(pm.loss_value)
        args, auxs = pm.get_params()
        params.append(({k: v.asnumpy() for k, v in args.items()},
                       {k: v.asnumpy() for k, v in auxs.items()}))
    return losses, pm.get_outputs()[0].asnumpy(), params


def _pair_modules(make, data_shape, opt, init, steps, batches):
    """The same pipeline in both packages from the JAX package's
    initial parameters, carried over whole."""
    jbase._name_counters.clear()
    jpm = make(jmx)
    jpm.bind(data_shapes=[("data", data_shape)])
    np.random.seed(7)
    jpm.init_params(init(jmx))
    jpm.init_optimizer(optimizer="sgd", optimizer_params=opt)
    carry = {k: np.asarray(v) for k, v in jpm.params.items()}
    aux = {"pipeline_flat": np.asarray(jpm._flat_auxs)} \
        if jpm._hetero else None
    jres = _fit(jmx, jpm, batches[:steps])
    tbase._name_counters.clear()
    with tmx.cpu():
        tpm = make(tmx)
        tpm.bind(data_shapes=[("data", data_shape)])
        tpm.init_params(arg_params=carry, aux_params=aux)
        tpm.init_optimizer(optimizer="sgd", optimizer_params=opt)
        tres = _fit(tmx, tpm, batches[:steps])
    return jpm, tpm, jres, tres


def _close(got, want, tol, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol[0],
                                   atol=tol[1], err_msg=f"{what} {k}")


def test_homogeneous_pipeline_module_matches_jax():
    """test_pipeline_under_jit's numbers through the step: a 4-stage
    tanh(FC) pipeline, 8 microbatches, SGD with momentum, 3 steps."""
    def make(mx):
        d = mx.sym.Variable("data")
        st = mx.sym.Activation(mx.sym.FullyConnected(
            d, num_hidden=8, flatten=False, no_bias=True, name="fc"),
            act_type="tanh", name="act")
        return mx.mod.PipelineModule(st, num_stages=4, num_microbatches=8,
                                     context=mx.cpu())

    rs = np.random.RandomState(0)
    batches = [(rs.rand(16, 2, 8).astype("float32"),
                rs.rand(16, 2, 8).astype("float32")) for _ in range(3)]
    jpm, tpm, (jl, jo, jp), (tl, to, tp) = _pair_modules(
        make, (16, 2, 8), (("learning_rate", 0.1), ("momentum", 0.9)),
        lambda mx: mx.initializer.Xavier(), 3, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    for (ta, _), (ja, _) in zip(tp, jp):
        _close(ta, ja, (1e-5, 1e-6), "fc")
    assert tpm.params["fc_weight"].shape == (4, 8, 8)
    assert len(tpm.params["fc_weight"].sharding.device_set) == 4
    # forward(is_train=False) is the JAX package's inference
    x = batches[0][0]
    jpm.forward(jmx.io.DataBatch(data=[jmx.nd.array(x)], label=None))
    with tmx.cpu():
        tpm.forward(tmx.io.DataBatch(data=[tmx.nd.array(x)], label=None))
    np.testing.assert_allclose(tpm.get_outputs()[0].asnumpy(),
                               jpm.get_outputs()[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)
    assert tpm._t == 3


def _bn_lm(mx, vocab=11, d=6):
    """embedding -> FC + BatchNorm -> FC + tanh -> head: shape changes at
    both ends, aux state in stage 1."""
    v = lambda: mx.sym.Variable("data")  # noqa: E731
    emb = mx.sym.Embedding(v(), input_dim=vocab, output_dim=d, name="emb")
    blk = mx.sym.BatchNorm(mx.sym.FullyConnected(
        v(), num_hidden=d, flatten=False, no_bias=True, name="b1fc"),
        name="bn")
    blk2 = mx.sym.Activation(mx.sym.FullyConnected(
        v(), num_hidden=d, flatten=False, no_bias=True, name="b2fc"),
        act_type="tanh", name="b2act")
    head = mx.sym.FullyConnected(v(), num_hidden=vocab, flatten=False,
                                 no_bias=True, name="head")
    return [emb, blk, blk2, head]


def test_hetero_lm_with_batchnorm_matches_jax():
    vocab, t = 11, 4

    def make(mx):
        return mx.mod.PipelineModule(_bn_lm(mx, vocab), num_microbatches=4,
                                     context=mx.cpu(), loss="softmax_ce")

    rs = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        x = rs.randint(0, vocab, (8, t)).astype("float32")
        batches.append((x, np.roll(x, -1, axis=1)))
    _, tpm, (jl, jo, jp), (tl, to, tp) = _pair_modules(
        make, (8, t), (("learning_rate", 0.5),),
        lambda mx: mx.initializer.Xavier(rnd_type="gaussian",
                                         magnitude=1.0), 3, batches)
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL[0])
    np.testing.assert_allclose(to, jo, rtol=STEP_TOL[0], atol=STEP_TOL[1])
    for (ta, tx), (ja, jx) in zip(tp, jp):
        _close(ta, ja, STEP_TOL, "param")
        _close(tx, jx, STEP_TOL, "aux")
    assert set(jp[-1][1]) == {"stage1/bn_moving_mean",
                              "stage1/bn_moving_var"}
    assert np.abs(jp[-1][1]["stage1/bn_moving_mean"]).max() > 0
    assert tuple(tpm.params["pipeline_flat"].shape)[0] == 4


def test_tied_bf16_lm_matches_jax_and_copies_stay_bit_equal():
    replayed = replay("test_pipeline_moe.py")
    vocab, d, B, t = 13, 8, 8, 4

    def make(mx):
        stages = (replayed["_tied_lm_stages"](vocab, d) if mx is tmx
                  else _jax_tied_stages(vocab, d))
        return mx.mod.PipelineModule(
            stages, num_microbatches=4, context=mx.cpu(),
            loss="softmax_ce",
            tied_params=[("stage0/emb_weight", "stage2/head_weight")])

    rs = np.random.RandomState(11)
    batches = []
    for _ in range(3):
        x = rs.randint(0, vocab, (B, t)).astype("float32")
        batches.append((x, (x + 1) % vocab))
    _, _, (jl, _, jp), (tl, _, tp) = _pair_modules(
        make, (B, t), (("learning_rate", 0.5),),
        lambda mx: mx.initializer.Xavier(rnd_type="gaussian",
                                         magnitude=1.0), 3, batches)
    for (ta, _), (ja, _) in zip(tp, jp):
        np.testing.assert_array_equal(ta["stage0/emb_weight"],
                                      ta["stage2/head_weight"])
        np.testing.assert_array_equal(ja["stage0/emb_weight"],
                                      ja["stage2/head_weight"])
        for k in ja:
            scale = max(np.abs(ja[k]).max(), 1e-6)
            assert np.abs(ta[k] - ja[k]).max() <= 5e-3 * scale, k
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


def _jax_tied_stages(vocab, d):
    from test_pipeline_moe import _tied_lm_stages

    return _tied_lm_stages(vocab, d)


# ------------------------------------------------- MoE tower via Module
def test_moe_transformer_module_on_data_expert_mesh_matches_jax():
    from mxnet_tpu.models import get_transformer as jget
    from mxnet_tpu_torch.models import get_transformer as tget

    kw = dict(d_model=16, num_heads=2, d_ff=32, num_layers=2,
              causal=False, moe_every=2, num_experts=4,
              capacity_factor=0.5)
    b, t, d = 8, 8, 16
    mesh = {"data": 2, "expert": 4}

    def build(mx, get):
        mod = mx.mod.Module(get(**kw), label_names=("label",),
                            context=[mx.cpu()], mesh_shape=mesh)
        mod.bind(data_shapes=[("data", (b, t, d))],
                 label_shapes=[("label", (b, t, d))])
        return mod

    jbase._name_counters.clear()
    jmod = build(jmx, jget)
    jmod.init_params(jmx.initializer.Xavier(rnd_type="gaussian",
                                            magnitude=1.0))
    jmod.init_optimizer(optimizer="sgd",
                        optimizer_params=(("learning_rate", 0.1),))
    init = tuple({k: v.asnumpy().copy() for k, v in table.items()}
                 for table in jmod.get_params())
    tbase._name_counters.clear()
    with tmx.cpu():
        tmod = build(tmx, tget)
        tmod.init_params(tmx.initializer.Xavier())
        tmod.set_params(*params_from_jax(*init, ctx=tmx.cpu()))
        tmod.init_optimizer(optimizer="sgd",
                            optimizer_params=(("learning_rate", 0.1),))
    rs = np.random.RandomState(3)
    tmoe.reset_stats()
    for _ in range(3):
        x = rs.uniform(-1, 1, (b, t, d)).astype("float32")
        y = rs.uniform(-1, 1, (b, t, d)).astype("float32")
        for mx, mod in ((jmx, jmod), (tmx, tmod)):
            mod.forward_backward(mx.io.DataBatch(
                data=[mx.nd.array(x, ctx=mx.cpu())],
                label=[mx.nd.array(y, ctx=mx.cpu())]))
            mod.update()
        np.testing.assert_allclose(
            tmod.get_outputs()[0].asnumpy(),
            jmod.get_outputs()[0].asnumpy(), rtol=STEP_TOL[0],
            atol=STEP_TOL[1])
    assert tmod._fused_step is not None
    assert dict(tmod._fused_step._mesh.shape) == mesh
    st = tmoe.stats()
    assert st["dropped"] > 0 and st["experts_computed"] == st["experts"]
    got = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}
    want = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    assert any(k.endswith("moe_w1_weight") for k in want)
    _close(got, want, STEP_TOL, "param")
    moved = np.abs(want["layer1_moe_w1_weight"]
                   - init[0]["layer1_moe_w1_weight"]).max()
    assert moved > 0


def test_inception_pipeline_stages_compose_to_the_classifier():
    """models/inception_resnet_v2.py's `get_pipeline_stages`, run one
    after another from the same weights, give the classifier's logits
    bit for bit, and every stage holds BatchNorm."""
    from mxnet_tpu_torch.models import inception_resnet_v2 as irv

    shape, rep = (1, 3, 75, 75), (1, 1, 1)
    with tmx.cpu():
        whole = irv.get_inception_resnet_v2(
            num_classes=10, repeats=rep, dropout=0).get_internals()[
                "fc1_output"]
        stages = irv.get_pipeline_stages(num_classes=10, repeats=rep)
        ex = whole.simple_bind(grad_req="null", data=shape)
        rs = np.random.RandomState(4)
        for n, a in ex.arg_dict.items():
            a[:] = rs.standard_normal(a.shape).astype(np.float32) * 0.2
        for n, a in ex.aux_dict.items():
            a[:] = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        want = ex.forward(is_train=False)[0].asnumpy()
        h = ex.arg_dict["data"]
        for st in stages:
            assert st.list_auxiliary_states(), "a stage without BatchNorm"
            sx = st.simple_bind(grad_req="null", data=h.shape)
            sx.copy_params_from(
                {n: ex.arg_dict[n] for n in st.list_arguments()
                 if n != "data"},
                {n: ex.aux_dict[n] for n in st.list_auxiliary_states()})
            h = sx.forward(is_train=False, data=h)[0]
    np.testing.assert_array_equal(h.asnumpy(), want)
