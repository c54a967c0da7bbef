"""The Module family of the port (BucketingModule, SequentialModule,
PythonLossModule, Module.cast_compute) against the JAX package's, on
the CPU, at vocabulary 40, embedding 8, hidden 16, 2 LSTM layers,
buckets of 4, 8 and 12 tokens, batch 4; the MLPs 20 -> 32 -> 10 at
batch 64.

- BucketingModule over `lstm_lm_sym_gen`: under one seed the iterator
  gives both packages the same batches in the same order, and after 5
  SGD steps (lr 0.5, clip 5) over the 3 buckets every parameter is
  within 1e-5 (absolute and relative) of the JAX package's: the same
  float32 ops summed in other orders, as in test_torch_lstm_lm.py. Every
  bucket's parameters and gradients are the default bucket's storage
  (`data_ptr`), and a second pass over the buckets binds nothing,
  creates no executor and builds no fusion kernel.
- SequentialModule (a feature Module into a head Module, take_labels
  and auto_wiring) and SequentialModule with a PythonLossModule (a hinge
  gradient computed in numpy): parameters after 4 SGD steps within
  1e-5 of the JAX package's.
- cast_compute(bfloat16) against the JAX package's fused step with
  cast_compute(jnp.bfloat16) (tests/test_fused_step.py's MLP, and the
  same MLP with an elementwise fusion group, whose plain version then
  runs in bfloat16): after 6 SGD steps (momentum 0.9) each parameter
  differs from the JAX package's by at most BF16_TOL of how far it
  moved. The JAX package sums the bias gradient over the 64 rows in
  bfloat16, rounding each partial sum to an 8-bit mantissa (2^-9
  relative, about sqrt(64) x 2^-9 = 1.6% typical after 64 terms), the
  port in float32; BF16_TOL is three times that typical drift. The
  master weights stay float32 and the bfloat16 run differs from the
  float32 one; set_params before cast_compute takes effect; labels
  above 256 (not bfloat16 numbers) are never cast; uint8 data is
  promoted to the compute dtype.
- simple_bind(group2ctx=) over two ctx_groups: outputs and gradients
  within 1e-5 of the JAX package's; a group on an unreachable card is
  refused.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.base as jbase  # noqa: E402
import mxnet_tpu.models as jmodels  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
import mxnet_tpu_torch.base as tbase  # noqa: E402
import mxnet_tpu_torch.models as tmodels  # noqa: E402

TOL = 1e-5
BF16_TOL = 5e-2
VOCAB, EMBED, HIDDEN, LAYERS, BATCH = 40, 8, 16, 2, 4
BUCKETS = [4, 8, 12]
STEPS = 5


# knobs that change which path a bind takes; an earlier test file in the
# same process may have left them in os.environ (tests/test_pallas_codegen
# .py writes MXNET_FUSION_INTERPRET=1 and MXNET_FUSION_CODEGEN there, and
# its fixture only removes what was set before it ran)
PATH_KNOBS = ("MXNET_GRAPH_PASSES", "MXNET_FUSION_CODEGEN",
              "MXNET_FUSION_MIN_GROUP", "MXNET_FUSION_INTERPRET")


@pytest.fixture(autouse=True)
def _default_path_knobs(monkeypatch):
    """Every test here binds under the default pass pipeline and
    codegen, as it does in a process of its own: with
    MXNET_FUSION_INTERPRET=1 left behind, the JAX package lowers the
    cast_compute(bfloat16) group through its Pallas kernel in interpret
    mode, which raises inside the JAX package ('Invalid dtype for
    `swap`'), instead of through its lax twin."""
    for var in PATH_KNOBS:
        monkeypatch.delenv(var, raising=False)


def _fresh():
    jbase._name_counters.clear()
    tbase._name_counters.clear()


def _corpus():
    rs = np.random.RandomState(6)
    return [list(rs.randint(1, VOCAB, size=rs.randint(2, 13)))
            for _ in range(60)]


def _bucketing(mx, steps=STEPS):
    """A BucketingModule after `steps` SGD steps (at most one pass);
    returns the module, the bucket keys in order and the iterator."""
    mx.random.seed(1)   # its first 5 batches visit every bucket
    it = mx.rnn.BucketSentenceIter(_corpus(), BATCH, buckets=list(BUCKETS),
                                   invalid_label=0)
    models = jmodels if mx is jmx else tmodels
    sym_gen = models.lstm_lm_sym_gen(VOCAB, num_embed=EMBED,
                                     num_hidden=HIDDEN, num_layers=LAYERS)
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(5)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.5),
                                         ("clip_gradient", 5.0)))
    keys = []
    for i, batch in enumerate(it):
        if i == steps:
            break
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        keys.append(batch.bucket_key)
    return mod, keys, it


def test_bucketing_sgd_steps_match_jax():
    _fresh()
    jmod, jkeys, _ = _bucketing(jmx)
    _fresh()
    with tmx.cpu():
        tmod, tkeys, _ = _bucketing(tmx)
    assert tkeys == jkeys and set(tkeys) == set(BUCKETS), tkeys
    ja, _ = jmod.get_params()
    ta, _ = tmod.get_params()
    assert sorted(ta) == sorted(ja) == ["embed_weight", "lstm_parameters",
                                        "pred_bias", "pred_weight"]
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_buckets_share_storage_and_revisits_bind_nothing():
    from mxnet_tpu_torch import executor, passes

    _fresh()
    with tmx.cpu():
        mod, keys, it = _bucketing(tmx, steps=100)
        assert set(keys) == set(BUCKETS)
        root = mod._buckets[it.default_bucket_key]._exec_group.execs[0]
        for key, bucket in mod._buckets.items():
            exe = bucket._exec_group.execs[0]
            for name in ("lstm_parameters", "embed_weight", "pred_weight",
                         "pred_bias"):
                assert exe.arg_dict[name].data.data_ptr() == \
                    root.arg_dict[name].data.data_ptr(), (key, name)
                assert exe.grad_dict[name].data.data_ptr() == \
                    root.grad_dict[name].data.data_ptr(), (key, name)
        before = (executor.stats(), passes.fusion_stats()["kernels_built"],
                  mod.bucket_stats())
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        after = (executor.stats(), passes.fusion_stats()["kernels_built"],
                 mod.bucket_stats())
    assert after[0] == before[0] and after[1] == before[1]
    assert after[2]["binds"] == before[2]["binds"] == len(BUCKETS)
    assert after[2]["revisits"] - before[2]["revisits"] == len(keys)


def test_shared_module_refusals():
    _fresh()
    with tmx.cpu():
        net = tmx.models.get_lstm_lm(VOCAB, EMBED, HIDDEN, LAYERS, 4)[0]
        other = tmx.models.get_lstm_lm(VOCAB, EMBED, HIDDEN + 1, LAYERS,
                                       4)[0]
        shapes = ([("data", (BATCH, 4))], [("softmax_label", (BATCH, 4))])
        root = tmx.mod.Module(net, context=tmx.cpu())
        with pytest.raises(tbase.MXNetError, match="bound and initialized"):
            tmx.mod.Module(net, context=tmx.cpu()).bind(
                *shapes, shared_module=root)
        root.bind(*shapes)
        root.init_params(tmx.init.Xavier())
        with pytest.raises(tbase.MXNetError, match="share their param"):
            tmx.mod.Module(other, context=tmx.cpu()).bind(
                *shapes, shared_module=root)


# ------------------------------------------------------ SequentialModule
def _blobs(rs, n=32, feat=16, classes=4):
    y = rs.randint(0, classes, n)
    x = rs.randn(n, feat).astype("float32") * 0.4
    for c in range(classes):
        x[y == c, c] += 2.0
    return x, y.astype("float32")


def _hinge_grad(scores, labels):
    s = scores.asnumpy()
    y = labels.asnumpy().astype(int)
    n = len(y)
    margin = 1.0 + s - s[np.arange(n), y][:, None]
    margin[np.arange(n), y] = 0.0
    viol = (margin > 0).astype(s.dtype)
    grad = viol.copy()
    grad[np.arange(n), y] = -viol.sum(1)
    return grad / n


def _sequential(mx, loss_module, steps=4):
    sym = mx.sym
    seq = mx.mod.SequentialModule()
    feat = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                             name="feat_fc", num_hidden=12),
                          act_type="relu")
    if loss_module:
        scores = sym.FullyConnected(feat, name="fc2", num_hidden=4)
        seq.add(mx.mod.Module(scores, label_names=[], context=[mx.cpu()]))
        seq.add(mx.mod.PythonLossModule(grad_func=_hinge_grad),
                take_labels=True, auto_wiring=True)
    else:
        head = sym.SoftmaxOutput(sym.FullyConnected(
            sym.Variable("data"), name="head_fc", num_hidden=4),
            name="softmax")
        seq.add(mx.mod.Module(feat, label_names=[], context=[mx.cpu()]))
        seq.add(mx.mod.Module(head, context=[mx.cpu()]), take_labels=True,
                auto_wiring=True)
    seq.bind(data_shapes=[("data", (32, 16))],
             label_shapes=[("softmax_label", (32,))])
    mx.random.seed(4)
    seq.init_params(mx.initializer.Uniform(0.1))
    seq.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.3),))
    rs = np.random.RandomState(2)
    outs = []
    for _ in range(steps):
        x, y = _blobs(rs)
        seq.forward_backward(mx.io.DataBatch(data=[mx.nd.array(x)],
                                             label=[mx.nd.array(y)]))
        seq.update()
        outs.append(seq.get_outputs()[0].asnumpy())
    return seq, outs


@pytest.mark.parametrize("loss_module", [False, True])
def test_sequential_module_matches_jax(loss_module):
    _fresh()
    jseq, jouts = _sequential(jmx, loss_module)
    _fresh()
    with tmx.cpu():
        tseq, touts = _sequential(tmx, loss_module)
        assert tseq.output_shapes == [(n, tuple(s)) for n, s in
                                      jseq.output_shapes]
        assert tseq.data_names == jseq.data_names == ["data"]
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    ja, _ = jseq.get_params()
    ta, _ = tseq.get_params()
    assert sorted(ta) == sorted(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_python_loss_module_passes_scores_and_grad():
    with tmx.cpu():
        loss = tmx.mod.PythonLossModule(grad_func=lambda s, y: s.asnumpy()
                                        * 2.0)
        loss.bind([("data", (3, 4))], [("softmax_label", (3,))])
        assert loss.output_shapes == [("pyloss_output", (3, 4))]
        x = tmx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        loss.forward(tmx.io.DataBatch(data=[x], label=[tmx.nd.zeros(3)]),
                     is_train=True)
        assert loss.get_outputs()[0] is x
        loss.backward()
        np.testing.assert_array_equal(loss.get_input_grads()[0].asnumpy(),
                                      x.asnumpy() * 2.0)
        assert loss.get_params() == ({}, {})


# ----------------------------------------------------------- cast_compute
def _mlp(mx, group):
    d = mx.sym.Variable("data")
    f1 = mx.sym.FullyConnected(d, name="fc1", num_hidden=32)
    a1 = (mx.sym.square(mx.sym.sigmoid(f1)) * 0.5 if group
          else mx.sym.Activation(f1, name="relu1", act_type="relu"))
    f2 = mx.sym.FullyConnected(a1, name="fc2", num_hidden=10)
    return mx.sym.SoftmaxOutput(f2, name="softmax")


def _batch(mx):
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (64, 20)).astype("float32")
    y = rs.randint(0, 10, (64,)).astype("float32")
    return mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])


def _train(mx, dtype, group, steps=6):
    mod = mx.mod.Module(_mlp(mx, group), context=[mx.cpu()])
    mod.bind(data_shapes=[("data", (64, 20))],
             label_shapes=[("softmax_label", (64,))])
    mx.random.seed(7)
    mod.init_params(mx.initializer.Uniform(0.07))
    w0 = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),
                                         ("momentum", 0.9)))
    if mx is jmx:
        assert mod._fused_step is not None
    if dtype is not None:
        mod.cast_compute(dtype)
    b = _batch(mx)
    for _ in range(steps):
        mod.forward_backward(b)
        mod.update()
    if mx is jmx:
        mod.sync()
    return mod, w0, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, "bfloat16"])
@pytest.mark.parametrize("group", [False, True])
def test_cast_compute_bf16_matches_jax_fused_step(group, dtype):
    import jax.numpy as jnp

    from mxnet_tpu_torch import passes

    _, _, j16 = _train(jmx, jnp.bfloat16, group)
    with tmx.cpu():
        tmod, w0, t16 = _train(tmx, dtype, group)
        _, _, t32 = _train(tmx, None, group)
    exe = tmod._exec_group.execs[0]
    lowered = [d for _, d in exe._codegen_plan.cache_component
               if d.startswith("kernel:")]
    assert len(lowered) == (1 if group else 0)
    if group:
        (fused, _), = exe._codegen_plan.fused.values()
        assert [d for _, d in fused.in_avals] == [torch.bfloat16]
        assert passes.fusion_stats()["parity_failures"] == 0
    for k in j16:
        moved = np.abs(j16[k] - w0[k]).max()
        assert t16[k].dtype == np.float32
        assert exe.arg_dict[k].data.dtype == torch.float32
        assert np.abs(t16[k] - j16[k]).max() <= BF16_TOL * moved, k
        assert np.abs(t16[k] - t32[k]).max() > 1e-6, k
    # the fused step's outputs: the executor's arrays hold no step's
    assert tmod.get_outputs()[0].data.dtype == torch.bfloat16


def test_cast_compute_after_set_params_uses_the_new_weights():
    with tmx.cpu():
        mod, _, _ = _train(tmx, None, False, steps=2)
        args, auxs = mod.get_params()
        new = {k: tmx.nd.array(np.full(v.shape, 0.02, "float32"))
               for k, v in args.items()}
        mod.set_params(new, auxs)
        mod.cast_compute(torch.bfloat16)
        mod.forward(_batch(tmx), is_train=False)
        got = mod.get_outputs()[0].asnumpy()
        np.testing.assert_allclose(mod.get_params()[0]["fc1_weight"]
                                   .asnumpy(), 0.02, rtol=1e-6)
        fresh = tmx.mod.Module(_mlp(tmx, False), context=[tmx.cpu()])
        fresh.bind(data_shapes=[("data", (64, 20))],
                   label_shapes=[("softmax_label", (64,))])
        fresh.init_params(initializer=None, arg_params=new,
                          aux_params=auxs)
        fresh.cast_compute("bfloat16")
        fresh.forward(_batch(tmx), is_train=False)
        np.testing.assert_array_equal(got, fresh.get_outputs()[0].asnumpy())


def test_cast_compute_never_casts_labels():
    """Labels above 256 are not bfloat16 numbers (257 rounds to 256):
    the bias gradient of a 300-way SoftmaxOutput is negative exactly at
    the labels."""
    labels = np.array([257, 299, 3, 259], np.float32)
    with tmx.cpu():
        net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
            tmx.sym.Variable("data"), name="fc", num_hidden=300),
            name="softmax")
        mod = tmx.mod.Module(net, context=[tmx.cpu()])
        mod.bind(data_shapes=[("data", (4, 8))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(tmx.initializer.Uniform(0.01))
        mod.cast_compute(torch.bfloat16)
        mod.forward_backward(tmx.io.DataBatch(
            data=[tmx.nd.array(np.ones((4, 8), np.float32))],
            label=[tmx.nd.array(labels)]))
        exe = mod._exec_group.execs[0]
        grad = exe.grad_dict["fc_bias"].asnumpy()
        assert exe.arg_dict["softmax_label"].data.dtype == torch.float32
    assert exe.grad_dict["fc_bias"].data.dtype == torch.float32
    assert sorted(np.flatnonzero(grad < 0)) == sorted(labels.astype(int))


def test_cast_compute_promotes_unsigned_data():
    with tmx.cpu():
        net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), name="fc",
                                     num_hidden=3)
        exe = net.simple_bind(tmx.cpu(), grad_req="null",
                              type_dict={"data": np.uint8}, data=(2, 4))
        exe.arg_dict["fc_weight"][:] = np.full((3, 4), 0.5, np.float32)
        exe.arg_dict["data"][:] = np.array([[1, 2, 3, 200]] * 2, np.uint8)
        exe.cast_compute(torch.bfloat16)
        out = exe.forward()[0]
        assert out.data.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.asnumpy(), np.full((2, 3), 103.0))
        with pytest.raises(tbase.MXNetError, match="float dtype"):
            exe.cast_compute(torch.int32)


# ------------------------------------------------------------- group2ctx
def _grouped_net(mx):
    with mx.AttrScope(ctx_group="a"):
        h = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc1",
                                  num_hidden=6)
    with mx.AttrScope(ctx_group="b"):
        return mx.sym.FullyConnected(mx.sym.Activation(h, act_type="tanh"),
                                     name="fc2", num_hidden=3)


def test_group2ctx_places_groups_and_refuses_an_unreachable_context():
    """The JAX package's outputs and gradients from a bind whose two
    ctx_groups name contexts; a group on a card this process cannot
    reach raises instead of running elsewhere."""
    head = np.random.RandomState(4).uniform(-1, 1, (4, 3)).astype(
        np.float32)
    outs = {}
    for mx in (jmx, tmx):
        _fresh()
        net = _grouped_net(mx)
        with mx.cpu():
            ex = net.simple_bind(ctx=mx.cpu(), grad_req="write",
                                 group2ctx={"a": mx.cpu(0), "b": mx.cpu(1)},
                                 data=(4, 5))
            for n in sorted(ex.arg_dict):
                ex.arg_dict[n][:] = np.random.RandomState(len(n)).uniform(
                    -1, 1, ex.arg_dict[n].shape).astype(np.float32)
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward(out_grads=[mx.nd.array(head)])
            outs[mx] = (out, {n: g.asnumpy() for n, g in
                              ex.grad_dict.items()})
    np.testing.assert_allclose(outs[tmx][0], outs[jmx][0], rtol=TOL,
                               atol=TOL)
    for n, g in outs[jmx][1].items():
        np.testing.assert_allclose(outs[tmx][1][n], g, rtol=TOL, atol=TOL,
                                   err_msg=n)
    net = _grouped_net(tmx)
    with tmx.cpu(), pytest.raises(tbase.MXNetError, match="CUDA|reachable"):
        net.simple_bind(ctx=tmx.cpu(), group2ctx={"a": tmx.cpu(),
                                                  "b": tmx.gpu(7)},
                        data=(4, 5))
