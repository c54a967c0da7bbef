"""The fusion codegen (mxnet_tpu_torch.passes.codegen) against the JAX
package's (mxnet_tpu.passes.pallas_codegen), on the CPU.

The JAX side runs its generated Pallas kernels in interpret mode
(MXNET_FUSION_INTERPRET=1), as its own tests do; the port's groups run
their plain version on CPU tensors. Through simple_bind + forward +
backward both give the same outputs and gradients (1e-6), lower the
same groups with the same templates, and count the same static
fallbacks. The generated CUDA source is checked as text: it is the same
for the same group and signature, and calls no library kernel. The
kernels themselves run only on the card (tests/test_torch_codegen_cuda.py).
"""
import os
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import exec_cache  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.passes import codegen as cg  # noqa: E402

_KNOBS = ("MXNET_GRAPH_PASSES", "MXNET_FUSION_CODEGEN",
          "MXNET_FUSION_MIN_GROUP", "MXNET_FUSION_INTERPRET")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in _KNOBS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_FUSION_INTERPRET", "1")
    for mx in (jmx, tmx):
        mx.passes.clear_memo()
        mx.passes.reset_fusion_stats()
    exec_cache.clear()
    yield
    os.environ.pop("MXNET_FUSION_CODEGEN", None)
    for mx in (jmx, tmx):
        mx.passes.clear_memo()
        mx.passes.reset_fusion_stats()
    exec_cache.clear()


# ------------------------------------------------------------ the nets
def _elementwise(mx):
    x = mx.sym.Variable("x")
    return mx.sym.square(mx.sym.sigmoid(x)) * 0.5


def _scale_bias_act(mx):
    x, g, b = (mx.sym.Variable(n) for n in ("x", "g", "b"))
    h = mx.sym.elemwise_add(mx.sym.elemwise_mul(x, g), b)
    return mx.sym.Activation(h, act_type="tanh")


def _reduction(mx):
    x, y = mx.sym.Variable("x"), mx.sym.Variable("y")
    return mx.sym.sum(mx.sym.relu(x) * y)


def _mean_loss(mx):
    x, y = mx.sym.Variable("x"), mx.sym.Variable("y")
    return mx.sym.MakeLoss(mx.sym.mean(mx.sym.square(x - y)))


def _max_reduction(mx):
    x = mx.sym.Variable("x")
    return mx.sym.max(mx.sym.exp(x) * 0.25)


def _residual(scale, act):
    """Inception-ResNet-v2's `net + scale * proj` (+ relu)."""
    def build(mx):
        net, proj = mx.sym.Variable("net"), mx.sym.Variable("proj")
        out = net + proj * scale
        return mx.sym.Activation(out, act_type="relu") if act else out
    return build


CASES = {
    # name: (build, shapes, template)
    "elementwise": (_elementwise, {"x": (8, 128)}, "elementwise"),
    "elementwise_ragged": (_elementwise, {"x": (5, 7)}, "elementwise"),
    "scale_bias_act": (_scale_bias_act, {n: (8, 128) for n in "xgb"},
                       "scale_bias_act"),
    "reduction": (_reduction, {"x": (8, 128), "y": (8, 128)},
                  "reduction"),
    "reduction_mean_loss": (_mean_loss, {"x": (6, 10), "y": (6, 10)},
                            "reduction"),
    "reduction_max": (_max_reduction, {"x": (3, 5, 7)}, "reduction"),
    "block35": (_residual(0.17, True),
                {"net": (2, 8, 5, 5), "proj": (2, 8, 5, 5)},
                "scale_bias_act"),
    "b8_final": (_residual(0.2, False),
                 {"net": (2, 8, 3, 3), "proj": (2, 8, 3, 3)},
                 "elementwise"),
}


def _bind_run(mx, sym, shapes, vals, codegen):
    """simple_bind + forward(is_train) + backward on the CPU; returns
    (outputs, gradients, executor)."""
    os.environ["MXNET_FUSION_CODEGEN"] = codegen
    mx.passes.clear_memo()
    exec_cache.clear()
    exe = sym.simple_bind(mx.cpu(), **shapes)
    exe.forward(is_train=True,
                **{n: mx.nd.array(v) for n, v in vals.items()})
    outs = [o.asnumpy() for o in exe.outputs]
    exe.backward()
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None}
    return outs, grads, exe


def _vals(shapes, seed=0):
    rs = np.random.RandomState(seed)
    return {n: (rs.rand(*s) + 0.5).astype("float32")
            for n, s in shapes.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_bind_matches_jax(case):
    """B1-B3 through the Executor: the port's fused bind against the
    JAX package's fused bind (interpret-mode Pallas), forward and
    gradients within 1e-6, the same template lowered."""
    build, shapes, template = CASES[case]
    vals = _vals(shapes)
    j_outs, j_grads, _ = _bind_run(jmx, build(jmx), shapes, vals, "1")
    t_outs, t_grads, exe = _bind_run(tmx, build(tmx), shapes, vals, "1")
    st = tmx.passes.fusion_stats()
    assert st["groups_lowered"] == 1 and template in st["templates"], st
    assert exe._codegen_plan.fused, "no fused callable reached the plan"
    assert len(j_outs) == len(t_outs)
    for a, b in zip(j_outs, t_outs):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    assert set(j_grads) == set(t_grads)
    for n in j_grads:
        np.testing.assert_allclose(t_grads[n], j_grads[n], rtol=1e-6,
                                   atol=1e-6, err_msg=f"grad {n}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_matches_op_by_op(case):
    """Within the port: the fused bind equals the bind with every group
    run op by op (MXNET_FUSION_CODEGEN=0), and the plan records each
    decision."""
    build, shapes, _ = CASES[case]
    vals = _vals(shapes, seed=1)
    o0, g0, e0 = _bind_run(tmx, build(tmx), shapes, vals, "0")
    o1, g1, e1 = _bind_run(tmx, build(tmx), shapes, vals, "1")
    assert [d for _, d in e0._codegen_plan.cache_component] == \
        ["fallback:disabled"]
    assert e1._codegen_plan.cache_component[0][1].startswith("kernel:")
    for a, b in zip(o0, o1):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n], g0[n], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ fallback decisions
def _chain_of_leaky(mx):
    x = mx.sym.Variable("x")
    h = mx.sym.LeakyReLU(x, act_type="leaky", slope=0.1)
    return mx.sym.relu(h) * 2.0


def _broadcast_chain(mx):
    x, b = mx.sym.Variable("x"), mx.sym.Variable("b")
    return mx.sym.relu(mx.sym.broadcast_add(x, b)) * 2.0


FALLBACKS = {
    # name: (build, shapes, env, expected reason)
    "disabled": (_elementwise, {"x": (8, 128)},
                 {"MXNET_FUSION_CODEGEN": "0"}, "disabled"),
    "too_small": (_elementwise, {"x": (8, 128)},
                  {"MXNET_FUSION_MIN_GROUP": "5"}, "too_small"),
    "unsupported_op": (_chain_of_leaky, {"x": (8, 128)}, {},
                       "unsupported_op:LeakyReLU"),
    "irregular_shapes": (_broadcast_chain, {"x": (8, 128), "b": (1, 128)},
                         {}, "irregular_shapes"),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_decisions_match_jax(case, monkeypatch):
    """The counted static fallbacks: the same reasons and the same
    fusion_stats() in both packages, and the fallback bind still
    computes the same values."""
    build, shapes, env, reason = FALLBACKS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    codegen = env.get("MXNET_FUSION_CODEGEN", "1")
    vals = _vals(shapes, seed=2)
    j_outs, j_grads, _ = _bind_run(jmx, build(jmx), shapes, vals, codegen)
    t_outs, t_grads, exe = _bind_run(tmx, build(tmx), shapes, vals,
                                     codegen)
    js, ts = jmx.passes.fusion_stats(), tmx.passes.fusion_stats()
    keys = ("groups_seen", "groups_lowered", "groups_fallback",
            "fallback_reasons", "templates", "kernels_built",
            "parity_checks", "parity_failures")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["fallback_reasons"] == {reason: 1}
    assert not exe._codegen_plan.fused
    jr = {d: r["reason"] for d, r in jmx.passes.fusion_group_records()
          .items()}
    tr = {d: r["reason"] for d, r in tmx.passes.fusion_group_records()
          .items()}
    assert jr == tr
    for a, b in zip(j_outs, t_outs):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    for n in j_grads:
        np.testing.assert_allclose(t_grads[n], j_grads[n], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowered_stats_match_jax(case):
    build, shapes, _ = CASES[case]
    vals = _vals(shapes, seed=3)
    _bind_run(jmx, build(jmx), shapes, vals, "1")
    _bind_run(tmx, build(tmx), shapes, vals, "1")
    js, ts = jmx.passes.fusion_stats(), tmx.passes.fusion_stats()
    for k in ("groups_seen", "groups_lowered", "groups_fallback",
              "fallback_reasons", "templates", "kernels_built",
              "parity_checks", "parity_failures"):
        assert ts[k] == js[k], k


# ------------------------------------------------------ generated source
def _group(case, dtype=torch.float32):
    build, shapes, _ = CASES[case]
    os.environ["MXNET_FUSION_CODEGEN"] = "1"
    tmx.passes.clear_memo()
    exe = build(tmx).simple_bind(tmx.cpu(), **shapes)
    (group, _), = exe._codegen_plan.fused.values()
    return group


_LIBRARY = re.compile(
    r"cublas|cudnn|cutlass|cute::|thrust|cub::|\bat::|torch|c10|"
    r"cufft|curand|cusparse|cusolver|nccl", re.I)


def _code(text):
    """The source without its comments."""
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["float32", "bf16", "fp16"])
def test_generated_source_is_deterministic_and_self_contained(case, dtype):
    group = _group(case)
    dts = [dtype] * len(group.in_avals)
    src = cg.group_source(group.spec, group.template, dts, dtype,
                          group.digest)
    again = cg.group_source(_group(case).spec, group.template, dts, dtype,
                            group.digest)
    assert src == again
    assert group.digest in src
    includes = re.findall(r'#include\s+[<"]([^>"]+)[>"]', src)
    assert includes == ["fusion_codegen.cuh"]
    assert not _LIBRARY.search(_code(src))
    header = open(os.path.join(os.path.dirname(cg.__file__), "..", "csrc",
                               "fusion_codegen.cuh")).read()
    assert set(re.findall(r'#include\s+[<"]([^>"]+)[>"]', header)) == {
        "cuda_bf16.h", "cuda_fp16.h", "cuda_runtime.h", "math.h",
        "stdint.h"}
    assert not _LIBRARY.search(_code(header))
    entry = ("mxf_launch_reduce" if group.template == "reduction"
             else "mxf_launch")
    assert f'extern "C" int {entry}(' in src
    # scalar parameters are compile-time literals
    for op, params, _ in group.spec:
        if "scalar" in params:
            assert cg._lit(params["scalar"]) in src


def test_every_elemwise_op_has_a_device_expression():
    assert set(cg.ELEMWISE_OPS) - set(cg._EXPR) == {"LeakyReLU"}


# ------------------------------------------------------- device routing
def test_cpu_tensor_takes_plain_version_and_kernel_refuses_cpu():
    group = _group("block35")
    assert group.kernel is None
    ins = [torch.from_numpy(v) for v in _vals(
        {n: s for n, (s, _) in zip("ab", group.in_avals)}).values()]
    np.testing.assert_array_equal(group.run(*ins).numpy(),
                                  group.plain_fn(*ins).numpy())
    kern = cg.GeneratedKernel(group.template, "t", "", [torch.float32] * 2,
                              torch.float32)
    with pytest.raises(MXNetError, match="CUDA tensors"):
        kern(*ins, out_shape=group.out_shape)
    assert kern.launches == 0


def test_plan_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    build, shapes, _ = CASES["elementwise"]
    sym = tmx.passes.optimize(build(tmx))
    with pytest.raises(MXNetError, match="no CUDA device"):
        cg.plan_for(sym, input_shapes=shapes)
    with pytest.raises(MXNetError, match="no CUDA device"):
        build(tmx).simple_bind(**shapes)
