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
    batches = [mx.io.DataBatch(data=[mx.nd.array(x[i])],
                               label=[mx.nd.array(y[i])])
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
    batch_t = tmx.io.DataBatch(data=[tmx.nd.array(x[:16])], label=None)
    batch_j = jmx.io.DataBatch(data=[jmx.nd.array(x[:16])], label=None)
    tmod.forward(batch_t, is_train=False)
    jmod.forward(batch_j, is_train=False)
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_module_refuses_other_kvstores_and_devices():
    net = tmx.models.get_mlp(num_classes=5, hidden=(16, 8))
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 20))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    with pytest.raises(MXNetError, match="KVStore"):
        mod.init_optimizer(kvstore="device")
    with pytest.raises(MXNetError, match="one device"):
        tmx.mod.Module(net, context=[tmx.cpu(), tmx.cpu()])


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
        ws = [mx.nd.array(w) for w in w0]
        for step in grads:
            for i, g in enumerate(step):
                upd(i, mx.nd.array(g), ws[i])
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


@pytest.mark.parametrize("kind", ["factor", "multifactor"])
def test_lr_schedulers_match_jax(kind):
    vals = {}
    for key, mx in (("jax", jmx), ("torch", tmx)):
        sched = (mx.lr_scheduler.FactorScheduler(step=3, factor=0.5,
                                                 stop_factor_lr=1e-3)
                 if kind == "factor" else
                 mx.lr_scheduler.MultiFactorScheduler(step=[2, 5, 9],
                                                      factor=0.1))
        sched.base_lr = 0.2
        vals[key] = [sched(n) for n in range(1, 20)]
    np.testing.assert_allclose(vals["torch"], vals["jax"], rtol=1e-12)
