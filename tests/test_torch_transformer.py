"""The port's transformer tower and the ops, optimizer and metrics it
brings (SliceChannel, RingAttention, the regression heads, adam_update
and Adam, MAE/MSE/RMSE) against the JAX package's, on the CPU.

- `get_transformer` gives byte-identical JSON and the same inferred
  shapes and types in both packages, with and without `tp_axis`.
- Each op's forward values and input gradients, for one seeded head
  gradient per output, agree to 1e-5 of the output's magnitude (1e-4
  for RingAttention, a softmax over einsums summed in other orders).
- Adam's parameters and states after 5 updates agree to 1e-6 relative.
- The regression metrics agree to 1e-6 relative, on the host and the
  device path.
- Three forward_backward + update steps of the tower (d_model 32, 4
  heads, d_ff 64, 2 layers, batch 2, 16 tokens, Adam lr 1e-3) from the
  same weights (the JAX package's, carried by `params_from_jax`): the
  outputs agree to 1e-4, and each parameter's update (after minus
  before) agrees within `STEP_TOL` of that parameter's largest update.
  Adam divides each gradient by its running RMS, so an element whose
  gradient is near zero moves by a full step in a direction set by
  rounding; measured at this setting (lr 1e-3, three steps), the worst
  element was 1.5e-4 of its parameter's largest update
  (layer0_ffn_w2_weight).
"""
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.base as jbase  # noqa: E402
import mxnet_tpu.models.transformer as jtransformer  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
import mxnet_tpu_torch.base as tbase  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.models import get_transformer  # noqa: E402
from mxnet_tpu_torch.module.module import params_from_jax  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

OP_RTOL = 1e-5
ATTN_RTOL = 1e-4
STEP_TOL = 1e-2
OUT_TOL = 1e-4

TOWER = dict(d_model=32, num_heads=4, d_ff=64, num_layers=2)
B, T = 2, 16


def _pair(**kw):
    jbase._name_counters.clear()
    tbase._name_counters.clear()
    return (jtransformer.get_transformer(**kw), get_transformer(**kw))


# ----------------------------------------------------------------- graph
@pytest.mark.parametrize("kw", [TOWER, dict(TOWER, tp_axis="seq"),
                                dict(TOWER, causal=False, impl="ulysses",
                                     num_layers=3)])
def test_json_byte_identical(kw):
    j, t = _pair(**kw)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    if "tp_axis" in kw:
        attrs = json.loads(t.tojson())["nodes"]
        sharded = [n for n in attrs if "__sharding__" in n.get("attrs", {})]
        assert len(sharded) == 2 * kw["num_layers"]


@pytest.mark.parametrize("known", ["data_and_label", "data_only"])
def test_inferred_shapes_and_types_match(known):
    j, t = _pair(**TOWER)
    shapes = {"data": (B, T, 32)}
    if known == "data_and_label":
        shapes["label"] = (B, T, 32)
    js, ts = j.infer_shape(**shapes), t.infer_shape(**shapes)
    assert [list(map(tuple, x)) for x in ts] == \
        [list(map(tuple, x)) for x in js]
    assert dict(zip(t.list_arguments(), ts[0]))["layer0_attn_qkv_weight"] \
        == (96, 32)
    jt_, tt = j.infer_type(data=np.float32), t.infer_type(data=np.float32)
    assert [list(map(np.dtype, x)) for x in tt] == \
        [list(map(np.dtype, x)) for x in jt_]


def test_internal_shapes_match():
    j, t = _pair(**TOWER)
    ji, ti = j.get_internals(), t.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    _, jo, _ = ji.infer_shape(data=(B, T, 32))
    _, to, _ = ti.infer_shape(data=(B, T, 32))
    assert [tuple(s) for s in to] == [tuple(s) for s in jo]


def test_moe_raises_clear_error():
    """The MoE tower (refused until the mixture of experts was ported):
    byte-identical JSON, a JAX package graph that loads on the port, and
    one forward of both heads from the same weights against the JAX
    Module."""
    jg, tg = _pair(moe_every=1, num_experts=2, **TOWER)
    assert tg.tojson() == jg.tojson()
    loaded = tmx.sym.loads(jg.tojson())
    assert loaded.list_outputs() == tg.list_outputs() == \
        ["regress_output", "moe_aux_output"]
    rs = np.random.RandomState(8)
    x = rs.uniform(-1, 1, (B, T, TOWER["d_model"])).astype(np.float32)
    outs = []
    for mx, g in ((jmx, jg), (tmx, tg)):
        mod = mx.mod.Module(g, label_names=("label",), context=mx.cpu())
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("label", x.shape)], for_training=False)
        if mx is jmx:
            mod.init_params(jmx.initializer.Xavier())
            init = mod.get_params()
        else:
            mod.init_params(tmx.initializer.Xavier())
            mod.set_params(*params_from_jax(*init, ctx=tmx.cpu()))
        mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                                    label=[mx.nd.array(x, ctx=mx.cpu())]),
                    is_train=False)
        outs.append([o.asnumpy() for o in mod.get_outputs()])
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=OUT_TOL, atol=1e-6)


# ------------------------------------------------------------------- ops
def _op_pair(name, ins, params, grad_mask, seed=0):
    """Forward outputs and input gradients of op `name` in both
    packages, one seeded head gradient per output."""
    rs = np.random.RandomState(seed)
    top, jop = treg.get(name), jreg.get(name)
    tp, jp = top.normalize_params(params), jop.normalize_params(params)
    probe = top.fn(*[torch.tensor(x) for x in ins], **tp)
    probe = probe if isinstance(probe, tuple) else (probe,)
    heads = [rs.randn(*o.shape).astype(np.float32) for o in probe]

    xs = [jnp.asarray(x) for x in ins]

    def f(*diff):
        it = iter(diff)
        out = jop.fn(*[next(it) if m else x
                       for x, m in zip(xs, grad_mask)], **jp)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    j_outs, vjp = jax.vjp(f, *[x for x, m in zip(xs, grad_mask) if m])
    j_grads = vjp(tuple(jnp.asarray(h) for h in heads))

    txs = [torch.tensor(x).requires_grad_(bool(m))
           for x, m in zip(ins, grad_mask)]
    t_outs = top.fn(*txs, **tp)
    t_outs = t_outs if isinstance(t_outs, tuple) else (t_outs,)
    t_grads = torch.autograd.grad(
        t_outs, [x for x, m in zip(txs, grad_mask) if m],
        [torch.tensor(h) for h in heads])
    return ([np.asarray(o) for o in j_outs], [np.asarray(g) for g in j_grads],
            [o.detach().numpy() for o in t_outs],
            [g.numpy() for g in t_grads])


def _compare(name, ins, params, grad_mask, rtol):
    j_outs, j_grads, t_outs, t_grads = _op_pair(name, ins, params, grad_mask)
    assert len(t_outs) == len(j_outs)
    for kind, js, ts in (("output", j_outs, t_outs),
                         ("gradient", j_grads, t_grads)):
        for k, (a, b) in enumerate(zip(js, ts)):
            assert a.shape == b.shape, (name, kind, k)
            scale = max(float(np.abs(a).max()), 1.0)
            np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                       err_msg=f"{name} {kind} {k}")


@pytest.mark.parametrize("params", [
    {"causal": True}, {"causal": False}, {"causal": "True", "scale": "0.3"},
    {"causal": True, "impl": "ulysses"}])
def test_ring_attention_op(params):
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3))
    _compare("RingAttention", [q, k, v], params, [True] * 3, ATTN_RTOL)


def test_ring_attention_alias_and_defaults():
    op = treg.get("ring_attention")
    assert op is treg.get("RingAttention")
    assert op.normalize_params({}) == \
        jreg.get("RingAttention").normalize_params({})


@pytest.mark.parametrize("params,shape", [
    ({"num_outputs": 3, "axis": -1}, (2, 5, 12)),
    ({"num_outputs": 2}, (3, 4, 5)),
    ({"num_outputs": 4, "axis": 0, "squeeze_axis": True}, (4, 3, 2)),
    ({"num_outputs": "2", "axis": "2", "squeeze_axis": "False"},
     (2, 3, 6))])
def test_slice_channel_op(params, shape):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    _compare("SliceChannel", [x], params, [True], OP_RTOL)


def test_slice_channel_aliases():
    for alias in ("slice_channel", "split"):
        assert treg.get(alias) is treg.get("SliceChannel")
    op = treg.get("SliceChannel")
    assert op.resolved_num_outputs(op.normalize_params(
        {"num_outputs": "3"})) == 3


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput"])
@pytest.mark.parametrize("shape,label_shape,params", [
    ((2, 16, 8), (2, 16, 8), {}),
    ((6, 1), (6,), {"grad_scale": 0.5}),
    ((4, 3), (4, 3), {"grad_scale": "2"})])
def test_regression_heads(name, shape, label_shape, params):
    """Forward fwd(data); the data gradient is MXNet's
    grad_scale / prod(label.shape[1:]) * bwd(out, label), whatever the
    head gradient; the label gets none."""
    rs = np.random.RandomState(3)
    data = rs.randn(*shape).astype(np.float32)
    label = rs.rand(*label_shape).astype(np.float32)
    _compare(name, [data, label], params, [True, False], OP_RTOL)


def test_adam_update_op():
    rs = np.random.RandomState(4)
    ins = [rs.randn(5, 7).astype(np.float32) for _ in range(3)] + \
        [rs.rand(5, 7).astype(np.float32)]
    params = {"lr": 0.01, "wd": 0.1, "rescale_grad": 0.5,
              "clip_gradient": 0.4, "beta1": "0.8"}
    j_outs, _, t_outs, _ = _op_pair("adam_update", ins, params,
                                    [True, False, False, False])
    for a, b in zip(j_outs, t_outs):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("settings", [
    {"learning_rate": 1e-3},
    {"learning_rate": 0.05, "wd": 1e-2, "rescale_grad": 0.25,
     "clip_gradient": 0.5, "beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6}])
def test_adam_five_updates_match_jax(settings):
    rs = np.random.RandomState(5)
    w0 = [rs.randn(6, 4).astype(np.float32), rs.randn(9).astype(np.float32)]
    grads = [[rs.randn(*w.shape).astype(np.float32) for w in w0]
             for _ in range(5)]
    names = {0: "fc_weight", 1: "fc_bias"}

    def run(mx):
        opt = mx.optimizer.create("adam", param_idx2name=names, **settings)
        upd = mx.optimizer.get_updater(opt)
        ws = [mx.nd.array(w, ctx=mx.cpu()) for w in w0]
        for step in grads:
            for i, (w, g) in enumerate(zip(ws, step)):
                upd(i, mx.nd.array(g, ctx=mx.cpu()), w)
        states = {i: [s.asnumpy() for s in upd.states[i]] for i in names}
        return [w.asnumpy() for w in ws], states

    (jw, js), (tw, ts) = run(jmx), run(tmx)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    for i in names:
        for a, b in zip(js[i], ts[i]):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("name", ["mae", "mse", "rmse"])
@pytest.mark.parametrize("shapes", [((4, 3, 5), (4, 3, 5)), ((6,), (6, 1)),
                                    ((6,), (6, 3))])
def test_regression_metrics_match_jax(name, shapes):
    rs = np.random.RandomState(6)
    batches = [(rs.randn(*shapes[0]).astype(np.float32),
                rs.randn(*shapes[1]).astype(np.float32)) for _ in range(3)]
    for path in ("update", "update_device"):
        values = []
        for mx in (jmx, tmx):
            m = mx.metric.create(name)
            for label, pred in batches:
                getattr(m, path)([mx.nd.array(label, ctx=mx.cpu())],
                                 [mx.nd.array(pred, ctx=mx.cpu())])
            values.append(m.get())
            assert m.num_inst == 3
        (jn, jv), (tn, tv) = values
        assert tn == jn == name
        np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_regression_metric_refuses_misaligned_shapes():
    m = tmx.metric.create("mse")
    with pytest.raises(ValueError, match="incompatible"):
        m.update([tmx.nd.array(np.zeros((4, 2)), ctx=tmx.cpu())],
                 [tmx.nd.array(np.zeros((3, 2)), ctx=tmx.cpu())])


# ---------------------------------------------------------------- module
def _tower_run(mx, net, init=None, steps=3):
    rs = np.random.RandomState(7)
    xs = rs.randn(steps, B, T, 32).astype(np.float32)
    ys = rs.randn(steps, B, T, 32).astype(np.float32)
    mod = mx.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", (B, T, 32))],
             label_shapes=[("label", (B, T, 32))])
    if init is None:
        mx.random.seed(0)
        mod.init_params(mx.init.Xavier())
    else:
        mod.set_params(*init)
    args, _ = mod.get_params()
    before = {k: v.asnumpy().copy() for k, v in args.items()}
    mod.init_optimizer(kvstore="local", optimizer="adam",
                       optimizer_params={"learning_rate": 1e-3})
    metric = mx.metric.create("mse")
    outs = []
    for i in range(steps):
        batch = mx.io.DataBatch(data=[mx.nd.array(xs[i], ctx=mx.cpu())],
                                label=[mx.nd.array(ys[i], ctx=mx.cpu())])
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
        outs.append(mod.get_outputs()[0].asnumpy())
    args, _ = mod.get_params()
    return {"before": before, "outs": outs, "mse": metric.get()[1],
            "after": {k: v.asnumpy() for k, v in args.items()}}


@pytest.fixture(scope="module")
def towers():
    jnet, tnet = _pair(**TOWER)
    j = _tower_run(jmx, jnet)
    init = params_from_jax(j["before"], {}, ctx=tmx.cpu())
    return j, _tower_run(tmx, tnet, init=init)


def test_tower_three_adam_steps_match_jax(towers):
    j, t = towers
    assert sorted(t["after"]) == sorted(j["after"])
    for k in j["before"]:
        np.testing.assert_array_equal(t["before"][k], j["before"][k])
    for a, b in zip(j["outs"], t["outs"]):
        np.testing.assert_allclose(b, a, rtol=OUT_TOL, atol=OUT_TOL)
    for k in j["after"]:
        dj = j["after"][k] - j["before"][k]
        dt = t["after"][k] - t["before"][k]
        assert np.abs(dt).max() > 0, k
        err = np.abs(dt - dj).max() / np.abs(dj).max()
        assert err <= STEP_TOL, (k, err)
    assert np.isfinite(t["mse"])
    np.testing.assert_allclose(t["mse"], j["mse"], rtol=1e-4)


def test_tower_xavier_init_bit_identical():
    """Module.init_params(Xavier()) after mx.random.seed draws the same
    weights in both packages."""
    jnet, tnet = _pair(**TOWER)
    inits = []
    for mx, net in ((jmx, jnet), (tmx, tnet)):
        mod = mx.mod.Module(net, label_names=("label",), context=mx.cpu())
        mod.bind(data_shapes=[("data", (B, T, 32))],
                 label_shapes=[("label", (B, T, 32))])
        mx.random.seed(0)
        mod.init_params(mx.init.Xavier())
        inits.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in inits[0]:
        np.testing.assert_array_equal(inits[1][k], inits[0][k], err_msg=k)
