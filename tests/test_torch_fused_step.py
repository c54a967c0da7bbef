"""The port's fused train step (mxnet_tpu_torch/parallel/dp_step.py),
Module.run_steps, fit(steps_per_dispatch=) and the dispatch-ahead window
against the JAX package's, on the CPU (where the port's step body runs
uncaptured; tests/test_torch_fused_step_cuda.py holds its CUDA graph to
the same body on the card).

- The same numpy-seeded weights (the JAX module's initial parameters,
  carried over by `module.params_from_jax`) and batches go through the
  JAX package's fused step and the port's: after 3 steps the
  parameters, the optimizer states and the outputs agree within 1e-5
  (absolute, and relative to each tensor's largest magnitude) for SGD
  with momentum and weight decay, NAG, Adam, AdaGrad and RMSProp (plain
  and centered), with an lr scheduler, and with BatchNorm's moving
  statistics; under cast_compute(bfloat16) within 5e-2 of how far each
  parameter moved (test_torch_bucketing.py's bfloat16 bound).
- run_steps, stacked (4 per-step batches) and unstacked (one batch 4
  times), against the JAX package's run_steps, within 1e-5;
  fit(steps_per_dispatch=2) over 5 batches for 2 epochs against the JAX
  package's, within 1e-5, and the same cadence of batch_end_callback.
- Optimizer-state bytes cross formats and packages: the port's fused
  states load into the port's eager Updater and into the JAX package's
  fused step, the JAX package's fused and eager states load into the
  port's fused step, each with the values of the writer.
- tests/test_fused_step.py, tests/test_run_steps.py and
  tests/test_dispatch_ahead.py replayed on the port (the reference
  source with the module name `mxnet_tpu` read as `mxnet_tpu_torch`,
  under `with mx.cpu():`), the two mesh cases among them since the
  data-parallel slice (four host contexts under kvstore 'tpu': the step
  over the global batch; a batch the mesh does not divide runs eagerly).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import inspect  # noqa: E402
import pathlib  # noqa: E402
import pickle  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.module.module import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
BF16_TOL = 5e-2

# reference test -> the ROADMAP.md item that holds it back (none: the
# mesh cases run over cpu(0..3), the step over the global batch)
NOT_REPLAYED = {}


def _replay(test_file):
    """The namespace of a reference test file run against the port. The
    fused-state format string `mxnet_tpu/fused_v1` is a file format, not
    a module name, and stays."""
    path = ROOT / "tests" / test_file
    src = re.sub(r"\bmxnet_tpu\b(?!/)", "mxnet_tpu_torch", path.read_text())
    ns = {"__name__": f"replay_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    return ns


REPLAYED = {f: _replay(f) for f in ("test_fused_step.py",
                                    "test_run_steps.py",
                                    "test_dispatch_ahead.py")}


def _cases():
    out = []
    for f, ns in REPLAYED.items():
        for name, fn in ns.items():
            if name.startswith("test_") and callable(fn):
                marks = getattr(fn, "pytestmark", [])
                params = [m for m in marks if m.name == "parametrize"]
                values = params[0].args[1] if params else [None]
                for v in values:
                    case = f"{f}::{name}" + (f"[{v}]" if params else "")
                    if f"{f}::{name}" not in NOT_REPLAYED:
                        out.append((f, name, v, case))
            elif name.startswith("Test") and isinstance(fn, type):
                for m in sorted(dir(fn)):
                    if m.startswith("test_"):
                        out.append((f, f"{name}.{m}", None,
                                    f"{f}::{name}.{m}"))
    return out


CASES = _cases()


@pytest.mark.parametrize("f,name,value,case", CASES,
                         ids=[c[3] for c in CASES])
def test_replayed(f, name, value, case, tmp_path, monkeypatch):
    ns = REPLAYED[f]
    monkeypatch.delenv("MXNET_TPU_OPT_STATE_DTYPE", raising=False)
    if "." in name:
        cls, meth = name.split(".")
        fn = getattr(ns[cls](), meth)
    else:
        fn = ns[name]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (("tmp_path", tmp_path),
                                ("monkeypatch", monkeypatch))
              if k in params}
    if value is not None:
        kwargs[next(iter(params))] = value
    with tmx.cpu():
        fn(**kwargs)


def test_not_replayed_names_exist():
    for key in NOT_REPLAYED:
        f, name = key.split("::")
        assert name in REPLAYED[f], key


# -------------------------------------------------------------- parity
def _mlp(mx, bn=False):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(d, name="fc1", num_hidden=32)
    if bn:
        h = mx.sym.BatchNorm(h, name="bn1")
    h = mx.sym.Activation(h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(h, name="fc2", num_hidden=10)
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _batches(k, batch=16, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (k, batch, 20)).astype(np.float32)
    y = rs.randint(0, 10, (k, batch)).astype(np.float32)
    return x, y


def _batch(mx, x, y):
    return mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])


def _pair(opt, opt_params, bn=False, batch=16, dtype=None):
    """(JAX module, port module) bound, with the same initial weights
    and optimizer, both on their fused step."""
    mods = []
    init = None
    for mx in (jmx, tmx):
        with mx.cpu():
            mod = mx.mod.Module(_mlp(mx, bn), context=mx.cpu())
            mod.bind(data_shapes=[("data", (batch, 20))],
                     label_shapes=[("softmax_label", (batch,))])
            if init is None:
                mx.random.seed(5)
                mod.init_params(mx.initializer.Uniform(0.3))
                init = mod.get_params()
            else:
                args, auxs = params_from_jax(*init, ctx=tmx.cpu())
                mod.init_params(arg_params=args, aux_params=auxs)
            params = dict(opt_params)
            if "lr_scheduler" in params:
                params["lr_scheduler"] = params["lr_scheduler"](mx)
            mod.init_optimizer(optimizer=opt,
                               optimizer_params=tuple(params.items()))
            assert mod._fused_step is not None
            if dtype is not None:
                mod.cast_compute(dtype[0] if mx is jmx else dtype[1])
        mods.append(mod)
    return mods


def _host(x):
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x,
                      dtype=np.float32)


def _close(a, b, tol=TOL, what=""):
    a, b = _host(a), _host(b)
    scale = max(float(np.abs(a).max()), 1.0)
    assert np.abs(a - b).max() <= tol * scale, (what, np.abs(a - b).max())


def _state_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _state_leaves(t)]
    return [tree]


def _compare(jmod, tmod, tol=TOL):
    jmod._flush_fused()
    tmod._flush_fused()
    ja, jx = jmod.get_params()
    ta, tx = tmod.get_params()
    for n in ja:
        _close(ja[n], ta[n], tol, n)
    for n in jx:
        _close(jx[n], tx[n], tol, n)
    for n, s in jmod._fused_step.states.items():
        for a, b in zip(_state_leaves(s),
                        _state_leaves(tmod._fused_step.states[n])):
            _close(a, b.numpy(), tol, f"state of {n}")
    _close(jmod.get_outputs()[0], tmod.get_outputs()[0], tol, "output")
    assert jmod._fused_step._t == tmod._fused_step._t


def _factor(mx):
    return mx.lr_scheduler.FactorScheduler(step=1, factor=0.7)


OPTIMIZERS = {
    "sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    "sgd_plain": ("sgd", {"learning_rate": 0.1}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    "adagrad": ("adagrad", {"learning_rate": 0.1}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 0.01,
                                     "centered": True}),
    "sgd_scheduled": ("sgd", {"learning_rate": 0.2, "momentum": 0.9,
                              "lr_scheduler": _factor}),
    "sgd_clipped": ("sgd", {"learning_rate": 0.5, "clip_gradient": 0.01}),
}


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_fused_step_matches_jax(key):
    opt, params = OPTIMIZERS[key]
    jmod, tmod = _pair(opt, params)
    x, y = _batches(3)
    for i in range(3):
        for mod, mx in ((jmod, jmx), (tmod, tmx)):
            with mx.cpu():
                mod.forward_backward(_batch(mx, x[i], y[i]))
                mod.update()
    _compare(jmod, tmod)


def test_fused_step_with_batchnorm_matches_jax():
    jmod, tmod = _pair("sgd", {"learning_rate": 0.1, "momentum": 0.9},
                       bn=True)
    x, y = _batches(3)
    for i in range(3):
        for mod, mx in ((jmod, jmx), (tmod, tmx)):
            with mx.cpu():
                mod.forward_backward(_batch(mx, x[i], y[i]))
                mod.update()
    _compare(jmod, tmod)
    assert set(tmod._fused_step.auxs) == {"bn1_moving_mean",
                                          "bn1_moving_var"}


def test_fused_step_bf16_matches_jax():
    jmod, tmod = _pair("sgd", {"learning_rate": 0.1, "momentum": 0.9},
                       dtype=(jnp.bfloat16, torch.bfloat16))
    w0 = {n: _host(v).copy() for n, v in tmod._fused_step.params.items()}
    x, y = _batches(3)
    for i in range(3):
        for mod, mx in ((jmod, jmx), (tmod, tmx)):
            with mx.cpu():
                mod.forward_backward(_batch(mx, x[i], y[i]))
                mod.update()
    ja = {n: _host(v) for n, v in jmod._fused_step.params.items()}
    for n, v in tmod._fused_step.params.items():
        assert v.dtype == torch.float32
        moved = np.abs(ja[n] - w0[n]).max()
        assert np.abs(_host(v) - ja[n]).max() <= BF16_TOL * moved, n


@pytest.mark.parametrize("stacked", [True, False])
def test_run_steps_matches_jax(stacked):
    jmod, tmod = _pair("adam", {"learning_rate": 0.01})
    x, y = _batches(4)
    if not stacked:
        x, y = x[0], y[0]
    for mod, mx in ((jmod, jmx), (tmod, tmx)):
        with mx.cpu():
            mod.run_steps(_batch(mx, x, y), 4, stacked=stacked)
    _compare(jmod, tmod)
    assert tmod._fused_step._t == 4


def test_fit_steps_per_dispatch_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (80, 20)).astype(np.float32)
    y = rs.randint(0, 10, (80,)).astype(np.float32)
    with jmx.cpu():
        ref = jmx.mod.Module(_mlp(jmx), context=jmx.cpu())
        ref.bind(data_shapes=[("data", (16, 20))],
                 label_shapes=[("softmax_label", (16,))])
        jmx.random.seed(21)
        ref.init_params(jmx.initializer.Uniform(0.07))
        init = ref.get_params()
    got = {}
    for mx in (jmx, tmx):
        with mx.cpu():
            it = mx.io.NDArrayIter(x, y, batch_size=16, shuffle=False,
                                   label_name="softmax_label")
            mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
            args, auxs = init if mx is jmx else params_from_jax(
                *init, ctx=tmx.cpu())
            seen = []
            mod.fit(it, num_epoch=2, optimizer="sgd",
                    optimizer_params=(("learning_rate", 0.1),
                                      ("momentum", 0.9)),
                    arg_params=args, aux_params=auxs,
                    steps_per_dispatch=2,
                    batch_end_callback=lambda p, seen=seen: seen.append(
                        (p.epoch, p.nbatch)))
            got[mx is tmx] = (mod, seen)
    (jmod, jseen), (tmod, tseen) = got[False], got[True]
    # the groups' nbatch counts completed batches; the remainder's
    # single step numbers on from there (the JAX package's cadence)
    assert tseen == jseen == [(0, 2), (0, 4), (0, 5), (1, 2), (1, 4),
                              (1, 5)]
    ja, _ = jmod.get_params()
    ta, _ = tmod.get_params()
    for n in ja:
        _close(ja[n], ta[n], TOL, n)


# --------------------------------------------------- state formats
def _trained_pair():
    jmod, tmod = _pair("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    x, y = _batches(2)
    for i in range(2):
        for mod, mx in ((jmod, jmx), (tmod, tmx)):
            with mx.cpu():
                mod.forward_backward(_batch(mx, x[i], y[i]))
                mod.update()
    return jmod, tmod


def test_fused_state_bytes_cross_formats_and_packages():
    jmod, tmod = _trained_pair()
    blob = tmod._fused_step.get_states()
    obj = pickle.loads(blob)
    assert obj["format"] == "mxnet_tpu/fused_v1" and obj["t"] == 2
    assert all(isinstance(v, np.ndarray) for v in obj["states"].values())
    # the port's fused bytes -> the JAX package's fused step
    jfresh, tfresh = _pair("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    jfresh._fused_step.set_states(blob)
    for n, s in tmod._fused_step.states.items():
        np.testing.assert_array_equal(
            np.asarray(jfresh._fused_step.states[n]), s.numpy())
    assert jfresh._fused_step._t == 2
    # the JAX package's fused bytes -> the port's fused step
    tfresh._fused_step.set_states(jmod._fused_step.get_states())
    for n, s in jmod._fused_step.states.items():
        np.testing.assert_array_equal(
            tfresh._fused_step.states[n].numpy(), np.asarray(s))
    assert tfresh._fused_step._t == 2
    # the port's fused bytes -> the port's eager Updater: every index
    # of the name, the update counts seeded from t
    tfresh._disable_fused("test")
    tfresh._updater.set_states(blob)
    idx = {n: i for i, n in tfresh._optimizer.idx2name.items()}
    for n, s in tmod._fused_step.states.items():
        np.testing.assert_array_equal(
            tfresh._updater.states[idx[n]].asnumpy(), s.numpy())
    assert tfresh._optimizer.num_update == 2


def test_eager_state_bytes_load_into_the_fused_step():
    jmod, _ = _trained_pair()
    jmod._disable_fused("eager states")
    jblob = jmod._updater.get_states()
    _, tfresh = _pair("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    tfresh._fused_step.set_states(jblob)
    idx = {n: i for i, n in jmod._optimizer.idx2name.items()}
    for n, s in tfresh._fused_step.states.items():
        np.testing.assert_array_equal(
            s.numpy(), jmod._updater.states[idx[n]].asnumpy())
    with pytest.raises(tmx.MXNetError, match="structure"):
        bad = pickle.dumps({"format": "mxnet_tpu/fused_v1", "t": 1,
                            "states": {n: None for n in
                                       tfresh._fused_step.states}})
        tfresh._fused_step.set_states(bad)


def test_supports_fused_is_the_jax_packages_set():
    from mxnet_tpu.parallel.dp_step import supports_fused as jsup

    from mxnet_tpu_torch.parallel.dp_step import supports_fused as tsup

    for name in ("sgd", "nag", "sgld", "dcasgd", "adam", "adagrad",
                 "rmsprop", "adadelta", "ftrl", "test", "ccsgd"):
        assert tsup(tmx.optimizer.create(name)) == jsup(
            jmx.optimizer.create(name)), name


def test_mesh_and_plan_refuse_naming_a9():
    """The pipe and expert axes (the second part of A.9, refused until
    it was ported) are taken: a step over a one-process mesh with a pipe
    axis is the plain step (one device's global program)."""
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel.dp_step import FusedTrainStep

    rs = np.random.RandomState(0)
    batch = {"data": torch.tensor(rs.rand(16, 20).astype(np.float32)),
             "softmax_label": torch.tensor(
                 rs.randint(0, 10, 16).astype(np.float32))}
    with tmx.cpu():
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (16, 20))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params()
        mod.init_optimizer()
        after = []
        for mesh in (None, tmesh.make_mesh({"data": 1, "pipe": 2,
                                            "expert": 2})):
            fs = FusedTrainStep(mod._exec_group.execs[0], mod._optimizer,
                                mod._param_names, mesh=mesh)
            fs.step(dict(batch))
            after.append({n: v.clone() for n, v in fs.params.items()})
        assert dict(fs._mesh.shape) == {"data": 1, "pipe": 2, "expert": 2}
        for n in after[0]:
            assert torch.equal(after[0][n], after[1][n]), n


