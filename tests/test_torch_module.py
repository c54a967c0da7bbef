"""The port's training stack (Module, Executor, initializer, optimizer,
metrics, NDArrayIter) against the JAX package's, on the CPU.

Inception-ResNet-v2 at repeats=(1, 1, 1), 4 classes, no dropout, batch
2, fusion groups lowered in both packages (the JAX package's in
interpret mode):

- initial parameters are bit-identical under `mx.random.seed` (Xavier
  draws through numpy's global generator in both);
- the inference forward agrees within 1e-4;
- three SGD steps (momentum 0.9, wd 1e-4) agree within the tolerance
  stated at `STEP_TOL`.

The input is 139x139, not 75x75: at 75x75 the block8 stage is 1x1, so
training-mode BatchNorm normalizes each channel over 2 values and the
first gradients reach 5e4; the JAX package's float32 gradients there
are O(1) relative away from a float64 evaluation and its training
diverges within three steps. At 139x139 the stage is 3x3 (18 values a
channel) and both packages train.

An MLP runs Module.fit over an NDArrayIter in both packages; its
parameters and metric values agree to float32 rounding.

The lifecycle around training, on an MLP in both packages: predict and
iter_predict (the pad rows trimmed, merged or per batch); checkpoints
(symbol, params and optimizer states files byte-identical to the JAX
package's for the same weights and states, loaded across packages);
Module.load with its optimizer states, reshape, borrow_optimizer,
get_states/set_states and output_shapes; the checkpoint and logging
callbacks; Executor.reshape, output_dict and debug_str; Symbol.eval,
list_inputs, debug_str and canonical_signature. The lr schedulers are
bit-identical. The reference's tests/test_module.py and
tests/test_executor.py are replayed on the port where they use only
ported names.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401
import mxnet_tpu_torch as tmx  # noqa: E402
import mxnet_tpu_torch.models  # noqa: E402,F401
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.module.module import params_from_jax  # noqa: E402

B, S, CLASSES, STEPS = 2, 139, 4, 3
LR = 1e-4
# Three steps: the update each parameter took (params after minus
# initial) agrees within STEP_TOL of that parameter's largest update
# (parameters whose update is under 1e-3 of the largest update of the
# net are held to that floor). The JAX package's training-mode
# BatchNorm takes its variance in one pass (E[x^2] - E[x]^2) in float32;
# at this size its first gradients are a median 1.7e-3 (and up to a
# few 1e-2) relative away from a float64 evaluation, against 1e-5 for
# the port, and three steps compound it.
STEP_TOL = 0.25
STEP_MEDIAN_TOL = 0.03
FORWARD_TOL = 1e-4


def _irv2_run(mx):
    """Bind, seed, Xavier init, an inference forward, then STEPS
    training steps on seeded batches; returns numpy results."""
    net = mx.models.get_inception_resnet_v2(
        num_classes=CLASSES, repeats=(1, 1, 1), dropout=0.0)
    rs = np.random.RandomState(1)
    x = rs.randn(STEPS, B, 3, S, S).astype(np.float32)
    y = rs.randint(0, CLASSES, (STEPS, B)).astype(np.float32)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", (B, 3, S, S))],
             label_shapes=[("softmax_label", (B,))])
    mx.random.seed(0)
    mod.init_params(initializer=mx.init.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2))
    args, auxs = mod.get_params()
    init = ({k: v.asnumpy().copy() for k, v in args.items()},
            {k: v.asnumpy().copy() for k, v in auxs.items()})
    batches = [mx.io.DataBatch(data=[mx.nd.array(x[i], ctx=mx.cpu())],
                               label=[mx.nd.array(y[i], ctx=mx.cpu())])
               for i in range(STEPS)]
    mod.forward(batches[0], is_train=False)
    infer = mod.get_outputs()[0].asnumpy()
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", LR), ("momentum", 0.9), ("wd", 1e-4)))
    train_out = None
    for batch in batches:
        mod.forward(batch, is_train=True)
        if train_out is None:
            train_out = mod.get_outputs()[0].asnumpy()
        mod.backward()
        mod.update()
    args, auxs = mod.get_params()
    return {"init": init, "infer": infer, "train_out": train_out,
            "args": {k: v.asnumpy() for k, v in args.items()},
            "auxs": {k: v.asnumpy() for k, v in auxs.items()},
            "stats": mx.passes.fusion_stats()}


@pytest.fixture(scope="module")
def irv2():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_FUSION_INTERPRET", "1")
        for mx in (jmx, tmx):
            mx.passes.clear_memo()
            mx.passes.reset_fusion_stats()
        results = _irv2_run(jmx), _irv2_run(tmx)
    yield results
    for mx in (jmx, tmx):
        mx.passes.clear_memo()
        mx.passes.reset_fusion_stats()


def test_irv2_fusion_groups_lowered_in_both(irv2):
    j, t = irv2
    assert t["stats"]["groups_lowered"] == 4
    assert t["stats"]["groups_fallback"] == 0
    for k in ("groups_seen", "groups_lowered", "templates"):
        assert t["stats"][k] == j["stats"][k]


def test_irv2_initial_params_bit_identical(irv2):
    (ja, jx), (ta, tx) = irv2[0]["init"], irv2[1]["init"]
    assert sorted(ja) == sorted(ta) and sorted(jx) == sorted(tx)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    for k in jx:
        np.testing.assert_array_equal(tx[k], jx[k], err_msg=k)


def test_irv2_forward_matches_jax(irv2):
    j, t = irv2
    np.testing.assert_allclose(t["infer"], j["infer"], rtol=FORWARD_TOL,
                               atol=FORWARD_TOL)
    np.testing.assert_allclose(t["train_out"], j["train_out"],
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)


def test_irv2_three_sgd_steps_match_jax(irv2):
    j, t = irv2
    init = j["init"][0]
    upd = {k: np.abs(j["args"][k] - init[k]).max() for k in init}
    floor = 1e-3 * max(upd.values())
    rel = {}
    for k in init:
        dj = j["args"][k] - init[k]
        dt = t["args"][k] - init[k]
        assert np.isfinite(dt).all(), k
        rel[k] = np.abs(dt - dj).max() / max(upd[k], floor)
    worst = max(rel, key=rel.get)
    assert rel[worst] <= STEP_TOL, (worst, rel[worst])
    assert np.median(list(rel.values())) <= STEP_MEDIAN_TOL
    for k, a in j["auxs"].items():
        scale = max(float(np.abs(a).max()), 1.0)
        np.testing.assert_allclose(t["auxs"][k], a, rtol=0,
                                   atol=1e-3 * scale, err_msg=k)


# ------------------------------------------------------------------ MLP
def _mlp_fit(mx, num_epoch=1):
    rs = np.random.RandomState(3)
    x = rs.randn(64, 20).astype(np.float32)
    y = rs.randint(0, 5, 64).astype(np.float32)
    net = mx.models.get_mlp(num_classes=5, hidden=(16, 8))
    it = mx.io.NDArrayIter(x, y, batch_size=16, shuffle=False)
    mod = mx.mod.Module(net, context=mx.cpu())
    mx.random.seed(7)
    metric = mx.metric.create(["acc", "ce"])
    per_batch = []
    mod.fit(it, num_epoch=num_epoch, eval_metric=metric, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9),
                              ("wd", 1e-4)),
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=lambda p: per_batch.append(
                [v for _, v in p.eval_metric.get_name_value()]))
    return mod, metric.get_name_value(), np.array(per_batch), x, y


@pytest.mark.parametrize("num_epoch", [1, 2])
def test_mlp_fit_matches_jax(num_epoch):
    jmod, jm, jb, x, _ = _mlp_fit(jmx, num_epoch)
    tmod, tm, tb, _, _ = _mlp_fit(tmx, num_epoch)
    assert [n for n, _ in tm] == [n for n, _ in jm] == \
        ["accuracy", "cross-entropy"]
    np.testing.assert_allclose([v for _, v in tm], [v for _, v in jm],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-6)
    ja, _ = jmod.get_params()
    ta, _ = tmod.get_params()
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_params_from_jax_carries_trained_weights():
    """The JAX package's trained parameters, carried over with
    params_from_jax and Module.set_params, give the JAX forward."""
    jmod, _, _, x, _ = _mlp_fit(jmx)
    args, auxs = params_from_jax(*jmod.get_params(), ctx=tmx.cpu())
    assert all(isinstance(v, tmx.nd.NDArray) for v in args.values())
    net = tmx.models.get_mlp(num_classes=5, hidden=(16, 8))
    tmod = tmx.mod.Module(net, context=tmx.cpu())
    tmod.bind(data_shapes=[("data", (16, 20))],
              label_shapes=[("softmax_label", (16,))], for_training=False)
    tmod.set_params(args, auxs)
    batch_t = tmx.io.DataBatch(data=[tmx.nd.array(x[:16], ctx=tmx.cpu())],
                               label=None)
    batch_j = jmx.io.DataBatch(data=[jmx.nd.array(x[:16])], label=None)
    tmod.forward(batch_t, is_train=False)
    jmod.forward(batch_j, is_train=False)
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_module_refuses_other_kvstores_and_devices():
    """What still refuses: an unknown store, and distinct CUDA cards
    under one mesh in one process (one process a card, tools/launch.py).
    The pipe and expert mesh axes, refused until the second part of A.9,
    are taken."""
    from mxnet_tpu_torch.parallel import mesh as tmesh

    net = tmx.models.get_mlp(num_classes=5, hidden=(16, 8))
    mod = tmx.mod.Module(net, context=[tmx.cpu(), tmx.cpu()])
    mod.bind(data_shapes=[("data", (4, 20))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    with pytest.raises(MXNetError, match="unknown KVStore"):
        mod.init_optimizer(kvstore="nonsense")
    for kw in ({"mesh_shape": {"data": 2, "pipe": 2}},
               {"mesh_shape": {"expert": 2}},
               {"sharding": tmx.ShardingPlan({"pipe": 2})}):
        m = tmx.mod.Module(net, context=tmx.cpu(), **kw)
        assert m._mesh_shape == (kw.get("mesh_shape") or {"pipe": 2})
    cards = [tmx.Context("gpu", 0), tmx.Context("gpu", 1)]
    with pytest.raises(MXNetError, match="tools/launch.py"):
        tmesh.check_mesh(tmesh.Mesh(cards, ("data",)), "Module")
    assert tmesh.check_mesh(tmesh.make_mesh({"data": 2, "pipe": 2}),
                            "Module") == 1
    # the same context twice keeps the executor group; contexts of the
    # host under any ported axes make a mesh on one device
    assert tmesh.check_mesh(
        tmesh.Mesh([tmx.Context("cpu", 0), tmx.Context("cpu", 1)],
                   ("data",)), "Module") == 1
    assert tmesh.check_mesh(tmesh.make_mesh({"data": 2, "seq": 2}),
                            "Module") == 1


def test_module_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    net = tmx.models.get_mlp(num_classes=5, hidden=(16, 8))
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.mod.Module(net)


# --------------------------------------------------- optimizer, schedules
@pytest.mark.parametrize("momentum,clip", [(0.0, None), (0.9, None),
                                           (0.9, 0.05)])
def test_sgd_updater_matches_jax(momentum, clip):
    """SGD through `get_updater` (per parameter) in both packages, and
    the port's multi-tensor `update_multi` (Module.update's path), agree
    over three steps with wd, rescale_grad and clipping."""
    rs = np.random.RandomState(4)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    w0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    names = {0: "a_weight", 1: "a_bias", 2: "b_weight"}
    kw = dict(learning_rate=0.1, momentum=momentum, wd=1e-2,
              rescale_grad=0.5, clip_gradient=clip, param_idx2name=names)
    out = {}
    for key, mx in (("jax", jmx), ("torch", tmx)):
        opt = mx.optimizer.create("sgd", **kw)
        upd = mx.optimizer.get_updater(opt)
        ws = [mx.nd.array(w, ctx=mx.cpu()) for w in w0]
        for step in grads:
            for i, g in enumerate(step):
                upd(i, mx.nd.array(g, ctx=mx.cpu()), ws[i])
        out[key] = [w.asnumpy() for w in ws]
    opt = tmx.optimizer.create("sgd", **kw)
    ws = [torch.from_numpy(w.copy()) for w in w0]
    wts = [tmx.nd.NDArray(w) for w in ws]
    states = [opt.create_state(i, w) for i, w in enumerate(wts)]
    for step in grads:
        opt.update_multi(list(range(3)), wts,
                         [tmx.nd.NDArray(torch.from_numpy(g)) for g in step],
                         states)
    for a, b, c in zip(out["jax"], out["torch"], [w.numpy() for w in ws]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(c, a, rtol=1e-6, atol=1e-7)


SCHEDULERS = {
    "factor": lambda ls: ls.FactorScheduler(step=3, factor=0.5,
                                            stop_factor_lr=1e-3),
    "multifactor": lambda ls: ls.MultiFactorScheduler(step=[2, 5, 9],
                                                      factor=0.1),
    "poly": lambda ls: ls.PolyScheduler(max_update=12, base_lr=0.3, pwr=3),
    "cosine": lambda ls: ls.CosineScheduler(max_update=15, final_lr=0.01),
    "cosine_warmup": lambda ls: ls.CosineScheduler(
        max_update=15, warmup_steps=4, warmup_begin_lr=0.02),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_lr_schedulers_match_jax(kind):
    """Every schedule, bit for bit over the first 20 updates."""
    vals = {}
    for key, mx in (("jax", jmx), ("torch", tmx)):
        sched = SCHEDULERS[kind](mx.lr_scheduler)
        sched.base_lr = 0.2
        vals[key] = [sched(n) for n in range(0, 20)]
    assert vals["torch"] == vals["jax"]


# ------------------------------------------------------------ lifecycle
def _lifecycle_module(mx, batch=8, fit=True, optimizer="adam"):
    """An MLP Module on the host, fit one epoch when `fit`."""
    rs = np.random.RandomState(8)
    x = rs.randn(30, 12).astype(np.float32)
    y = rs.randint(0, 4, 30).astype(np.float32)
    net = mx.models.get_mlp(num_classes=4, hidden=(10,))
    mod = mx.mod.Module(net, context=mx.cpu())
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mx.random.seed(3)
    if fit:
        mod.fit(it, num_epoch=1, optimizer=optimizer,
                optimizer_params=_OPT_PARAMS[optimizer],
                initializer=mx.init.Xavier())
    return mod, it, x, y


_OPT_PARAMS = {"adam": (("learning_rate", 0.01),),
               "dcasgd": (("learning_rate", 0.05), ("momentum", 0.9)),
               "sgd": (("learning_rate", 0.05), ("momentum", 0.9))}


def test_predict_and_iter_predict_match_jax():
    got = {}
    for key, mx in (("jax", jmx), ("torch", tmx)):
        mod, it, _, _ = _lifecycle_module(mx)
        merged = mod.predict(it).asnumpy()
        per_batch = [o[0].asnumpy() for o in mod.predict(
            it, merge_batches=False)]
        listed = mod.predict(it, always_output_list=True)
        iterated = [(outs[0].asnumpy(), nbatch, batch.pad)
                    for outs, nbatch, batch in mod.iter_predict(it)]
        got[key] = (merged, per_batch, len(listed), iterated,
                    mod.output_shapes)
    j, t = got["jax"], got["torch"]
    assert t[0].shape == (30, 4)            # the pad rows are trimmed
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=1e-6)
    assert [b.shape for b in t[1]] == [b.shape for b in j[1]]
    assert t[2] == j[2] == 1
    assert [(n, p) for _, n, p in t[3]] == [(n, p) for _, n, p in j[3]]
    np.testing.assert_array_equal(np.concatenate([o for o, _, _ in t[3]]),
                                  t[0])
    assert t[4] == j[4]


def _assert_files_equal(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def test_checkpoint_files_byte_identical_to_jax(tmp_path):
    """With the JAX module's weights and optimizer states, the port
    writes the same symbol, params and states bytes. (DCASGD: the JAX
    package has no fused step for it, so its states file is the eager
    updater's, as the port's always is.)"""
    jmod, it, _, _ = _lifecycle_module(jmx, optimizer="dcasgd")
    jmod.save_checkpoint(str(tmp_path / "j"), 1, save_optimizer_states=True)
    tmod, _, _, _ = _lifecycle_module(tmx, fit=False)
    tmod.bind(data_shapes=[("data", (8, 12))],
              label_shapes=[("softmax_label", (8,))])
    tmod.set_params(*params_from_jax(*jmod.get_params(), ctx=tmx.cpu()))
    tmod.init_optimizer(optimizer="dcasgd",
                        optimizer_params=_OPT_PARAMS["dcasgd"])
    tmod.load_optimizer_states(str(tmp_path / "j-0001.states"))
    tmod.save_checkpoint(str(tmp_path / "t"), 1, save_optimizer_states=True)
    for suffix in ("-symbol.json", "-0001.params", "-0001.states"):
        _assert_files_equal(tmp_path / f"j{suffix}", tmp_path / f"t{suffix}")


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoints_load_across_packages(tmp_path, direction):
    """A checkpoint with its optimizer states (the JAX package's fused
    step writes them by name, the port by index) loads in the other
    package: the same predictions, and one more momentum-SGD step from
    the same batch gives the same parameters."""
    src, dst = (jmx, tmx) if direction == "jax_to_torch" else (tmx, jmx)
    mods = {}
    for key, mx, load in (("src", src, False), ("dst", dst, True)):
        if not load:
            smod, it, x, y = _lifecycle_module(mx, optimizer="sgd")
            smod.save_checkpoint(str(tmp_path / "ck"), 1,
                                 save_optimizer_states=True)
            mods[key] = smod
            continue
        dmod = mx.mod.Module.load(str(tmp_path / "ck"), 1,
                                  load_optimizer_states=True,
                                  context=mx.cpu())
        dmod.bind(data_shapes=[("data", (8, 12))],
                  label_shapes=[("softmax_label", (8,))])
        dmod.init_optimizer(optimizer="sgd",
                            optimizer_params=_OPT_PARAMS["sgd"])
        mods[key] = dmod
    outs, params = {}, {}
    for key, mx in (("src", src), ("dst", dst)):
        with mx.cpu():
            it = mx.io.NDArrayIter(x, y, batch_size=8)
            batch = mx.io.DataBatch([mx.nd.array(x[:8])],
                                    [mx.nd.array(y[:8])])
        outs[key] = mods[key].predict(it).asnumpy()
        mods[key].forward_backward(batch)
        mods[key].update()
        params[key] = {k: v.asnumpy()
                       for k, v in mods[key].get_params()[0].items()}
    np.testing.assert_allclose(outs["dst"], outs["src"], rtol=1e-5,
                               atol=1e-6)
    for k in params["src"]:
        np.testing.assert_allclose(params["dst"][k], params["src"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_module_load_resumes_bit_identically(tmp_path):
    """Module.load with its optimizer states, then one more step on both
    modules from the same batch: predictions and parameters agree bit
    for bit."""
    mod, it, x, y = _lifecycle_module(tmx)
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    back = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=tmx.cpu())
    back.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    back.init_optimizer(optimizer="adam",
                        optimizer_params=(("learning_rate", 0.01),))
    np.testing.assert_array_equal(back.predict(it).asnumpy(),
                                  mod.predict(it).asnumpy())
    # the update counts are not in the states file: carry them over
    back._optimizer._index_update_count = dict(
        mod._optimizer._index_update_count)
    back._optimizer.num_update = mod._optimizer.num_update
    batch = tmx.io.DataBatch([tmx.nd.array(x[:8], ctx=tmx.cpu())],
                             [tmx.nd.array(y[:8], ctx=tmx.cpu())])
    for m in (mod, back):
        m.forward_backward(batch)
        m.update()
    for a, b in zip(mod.get_params()[0].values(),
                    back.get_params()[0].values()):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_save_load_params_and_states(tmp_path):
    mod, it, _, _ = _lifecycle_module(tmx)
    fname = str(tmp_path / "p.params")
    mod.save_params(fname)
    other, _, _, _ = _lifecycle_module(tmx, fit=False)
    other.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    other.load_params(fname)
    np.testing.assert_array_equal(other.predict(it).asnumpy(),
                                  mod.predict(it).asnumpy())
    assert mod.get_states(merge_multi_context=False) == []
    mod.set_states()
    assert mod.output_shapes == [("softmax_output", (8, 4))]


def test_reshape_and_borrow_optimizer():
    mod, it, x, _ = _lifecycle_module(tmx)
    want = mod.predict(it).asnumpy()
    weights = mod._exec_group.param_arrays
    mod.reshape(data_shapes=[("data", (5, 12))],
                label_shapes=[("softmax_label", (5,))])
    assert mod._exec_group.param_arrays == weights      # shared arrays
    assert mod.output_shapes == [("softmax_output", (5, 4))]
    with tmx.cpu():
        it5 = tmx.io.NDArrayIter(x, None, batch_size=5)
    got = mod.predict(it5).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    other, _, _, _ = _lifecycle_module(tmx, fit=False)
    other.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    other.init_params()
    other.borrow_optimizer(mod)
    assert other._updater is mod._updater and other.optimizer_initialized


def test_checkpoint_and_logging_callbacks(tmp_path, caplog):
    import logging

    mod, it, _, _ = _lifecycle_module(tmx, fit=False)
    prefix = str(tmp_path / "cb")
    seen = []
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=2, optimizer="sgd",
                epoch_end_callback=[
                    tmx.callback.module_checkpoint(mod, prefix, period=2,
                                                   save_optimizer_states=True),
                    tmx.callback.do_checkpoint(prefix + "_do")],
                batch_end_callback=[tmx.callback.log_train_metric(2),
                                    tmx.callback.ProgressBar(4),
                                    lambda p: seen.append(p.nbatch)])
    assert not (tmp_path / "cb-0001.params").exists()
    for name in ("cb-0002.params", "cb-0002.states", "cb-symbol.json",
                 "cb_do-0001.params", "cb_do-0002.params"):
        assert (tmp_path / name).exists(), name
    assert any("Train-accuracy" in r.message for r in caplog.records)
    assert seen == [0, 1, 2, 3] * 2


# ------------------------------------------------- executor and symbol
def _graph(mx, swap=False):
    # the auto-named nodes (_mul_scalar, elemwise_add) take their names
    # from fresh counters, so the two packages' names agree whatever
    # other tests built before in this process
    mx.base._name_counters.clear()
    data = mx.sym.Variable("data")
    a = mx.sym.FullyConnected(data, num_hidden=6, name="fa")
    b = mx.sym.FullyConnected(data, num_hidden=6, name="fb")
    a, b = (b, a) if swap else (a, b)
    return mx.sym.Activation(a, act_type="relu", name="act") * 2.0 + b


def test_executor_reshape_output_dict_debug_str_match_jax():
    got = {}
    for key, mx in (("jax", jmx), ("torch", tmx)):
        rs = np.random.RandomState(6)
        ex = _graph(mx).simple_bind(ctx=mx.cpu(), data=(3, 5))
        for name in sorted(ex.arg_dict):
            ex.arg_dict[name][:] = np.random.RandomState(
                len(name)).randn(*ex.arg_dict[name].shape).astype(
                    np.float32)
        small = ex.reshape(data=(2, 5))
        assert small.arg_dict["fa_weight"] is ex.arg_dict["fa_weight"]
        small.arg_dict["data"][:] = rs.randn(2, 5).astype(np.float32)
        small.forward()
        got[key] = ({k: v.asnumpy() for k, v in small.output_dict.items()},
                    small.debug_str())
    (jd, js), (td, ts) = got["jax"], got["torch"]
    assert list(td) == list(jd) and ts == js
    for k in jd:
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-5, atol=1e-6)


def test_symbol_eval_list_inputs_debug_str_match_jax():
    vals = {n: np.random.RandomState(i).randn(*s).astype(np.float32)
            for i, (n, s) in enumerate([("data", (2, 5)),
                                        ("fa_weight", (6, 5)),
                                        ("fa_bias", (6,)),
                                        ("fb_weight", (6, 5)),
                                        ("fb_bias", (6,))])}
    got = {}
    for key, mx in (("jax", jmx), ("torch", tmx)):
        s = _graph(mx)
        out = s.eval(ctx=mx.cpu(), **{n: mx.nd.array(v, ctx=mx.cpu())
                                      for n, v in vals.items()})
        got[key] = (out[0].asnumpy(), s.list_inputs(), s.debug_str())
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-5,
                               atol=1e-6)
    assert got["torch"][1:] == got["jax"][1:]


def test_canonical_signature():
    """The reference's digest wherever the two pass pipelines give the
    same graph (here), and its promise: isomorphic symbols built in
    another order share a signature, different graphs do not."""
    for swap in (False, True):
        assert _graph(tmx, swap).canonical_signature() == \
            _graph(jmx, swap).canonical_signature()
    stats = tmx.passes.graph_pass_stats()["pipeline_runs"]
    d = tmx.sym.Variable("data")
    one = tmx.sym.Activation(d, act_type="relu") + tmx.sym.exp(d)
    two = tmx.sym.exp(d) + tmx.sym.Activation(d, act_type="relu")
    three = tmx.sym.Activation(d, act_type="tanh") + tmx.sym.exp(d)
    assert one.canonical_signature() == \
        tmx.sym.loads(one.tojson()).canonical_signature()
    assert one.canonical_signature() != three.canonical_signature()
    assert len(two.canonical_signature()) == 16
    assert tmx.passes.graph_pass_stats()["pipeline_runs"] == stats


REPLAYED_MODULE = ["test_module_fit_single_device",
                   "test_module_checkpoint_roundtrip",
                   "test_module_predict_and_outputs",
                   "test_module_input_grads", "test_module_fixed_params",
                   "test_bucketing_module", "test_sequential_module",
                   "test_module_fit_data_parallel_two_devices",
                   "test_module_update_on_kvstore",
                   "test_module_tpu_kvstore_facade"]
# reference tests that need unported parts -> the ROADMAP.md item
NOT_REPLAYED_MODULE = {}
REPLAYED_EXECUTOR = ["test_forward_simple", "test_backward_simple",
                     "test_backward_out_grads", "test_grad_req_add",
                     "test_simple_bind_mlp_train",
                     "test_batchnorm_aux_update", "test_dropout_train_vs_eval",
                     "test_executor_reshape", "test_copy_params_from",
                     "test_backward_mirror_matches_plain"]


@pytest.mark.parametrize("name", REPLAYED_MODULE)
def test_reference_module_test_on_the_port(name, tmp_path):
    from test_torch_ndarray import replay, run_replayed

    ns = replay("test_module.py")
    assert {n for n in ns if n.startswith("test_")} == \
        set(REPLAYED_MODULE) | set(NOT_REPLAYED_MODULE)
    run_replayed(ns, name, tmp_path)


@pytest.mark.parametrize("name", REPLAYED_EXECUTOR)
def test_reference_executor_test_on_the_port(name, tmp_path, monkeypatch):
    from test_torch_ndarray import replay

    ns = replay("test_executor.py")
    assert {n for n in ns if n.startswith("test_")} == set(REPLAYED_EXECUTOR)
    fn = ns[name]
    with tmx.cpu():
        if name == "test_backward_mirror_matches_plain":
            fn(monkeypatch)
        else:
            fn()
