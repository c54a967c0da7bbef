"""The port's Symbol and graph passes against the JAX package's, on the
CPU: the same nets built through both give byte-identical JSON, the
same inferred shapes and argument lists, and the pass pipeline stamps
the same `__fusion_group__` / `__fusion_codegen__` attributes with the
same group digests (the digests name the generated kernels, so they
must not drift).

Nets: the three fusion-codegen template nets of the JAX package's
tests, a net that exercises CSE, canonicalization and a reduction loss,
the MLP, and Inception-ResNet-v2 at repeats=(1, 1, 1).
"""
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.base as jbase  # noqa: E402
import mxnet_tpu.models  # noqa: E402,F401
import mxnet_tpu_torch as tmx  # noqa: E402
import mxnet_tpu_torch.base as tbase  # noqa: E402
import mxnet_tpu_torch.models  # noqa: E402,F401


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


def _pass_mix(mx):
    """Aliases to canonicalize, a repeated subexpression for CSE, scalar
    chains for the fusion hints, and a reduction behind a chain."""
    x, w = mx.sym.Variable("x"), mx.sym.Variable("w")
    a = mx.sym.Relu(x)
    b = mx.sym.relu(x)
    h = mx.sym.elemwise_add(a, b) * 2.0 + 1.0
    h = mx.sym.exp(mx.sym.negative(h))
    fc = mx.sym.FullyConnected(h, w, num_hidden=3, no_bias=True)
    loss = mx.sym.MakeLoss(mx.sym.mean(mx.sym.square(fc - 0.5)))
    return mx.sym.Group([loss, h])


NETS = {
    "elementwise": (_elementwise, {"x": (8, 128)}),
    "scale_bias_act": (_scale_bias_act,
                       {"x": (8, 128), "g": (8, 128), "b": (8, 128)}),
    "reduction": (_reduction, {"x": (8, 128), "y": (8, 128)}),
    "pass_mix": (_pass_mix, {"x": (4, 6)}),
    "mlp": (lambda mx: mx.models.get_mlp(num_classes=5, hidden=(16, 8)),
            {"data": (2, 20)}),
    "irv2": (lambda mx: mx.models.get_inception_resnet_v2(
        num_classes=4, repeats=(1, 1, 1), dropout=0.0),
        {"data": (2, 3, 75, 75)}),
}


def _pair(name):
    """The net built through both packages, from fresh name counters."""
    build, shapes = NETS[name]
    jbase._name_counters.clear()
    tbase._name_counters.clear()
    a = build(jmx)
    b = build(tmx)
    return a, b, shapes


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXNET_GRAPH_PASSES", "MXNET_FUSION_CODEGEN",
                "MXNET_FUSION_MIN_GROUP"):
        monkeypatch.delenv(var, raising=False)
    jmx.passes.clear_memo()
    tmx.passes.clear_memo()
    yield


@pytest.mark.parametrize("name", sorted(NETS))
def test_tojson_byte_identical(name):
    a, b, _ = _pair(name)
    assert a.tojson() == b.tojson()
    # and the port reads the JAX package's JSON back unchanged
    assert tmx.sym.loads(a.tojson()).tojson() == a.tojson()


@pytest.mark.parametrize("name", sorted(NETS))
def test_structure_key_identical(name):
    a, b, _ = _pair(name)
    assert a.structure_key() == b.structure_key()


@pytest.mark.parametrize("name", sorted(NETS))
def test_infer_shape_and_lists_identical(name):
    a, b, shapes = _pair(name)
    assert a.list_arguments() == b.list_arguments()
    assert a.list_outputs() == b.list_outputs()
    assert a.list_auxiliary_states() == b.list_auxiliary_states()
    sa = a.infer_shape(**shapes)
    sb = b.infer_shape(**shapes)
    assert [list(map(tuple, s)) for s in sa] == \
        [list(map(tuple, s)) for s in sb]


def _stamps(sym):
    nodes = json.loads(sym.tojson())["nodes"]
    return [(n["name"], n.get("attrs", {}).get("__fusion_group__"),
             n.get("attrs", {}).get("__fusion_codegen__"))
            for n in nodes]


@pytest.mark.parametrize("name", sorted(NETS))
def test_pipeline_stamps_and_digests_identical(name):
    """The default pipeline (dce, fold, cse, canonicalize, fusion_hints,
    codegen) rewrites both graphs the same way: equal optimized JSON,
    equal group tags and codegen stamps (`candidate:<digest>`)."""
    a, b, _ = _pair(name)
    oa = jmx.passes.optimize(a)
    ob = tmx.passes.optimize(b)
    assert _stamps(oa) == _stamps(ob)
    assert oa.tojson() == ob.tojson()
    stamped = [s for _, _, s in _stamps(ob) if s]
    if name in ("elementwise", "scale_bias_act", "reduction", "irv2"):
        assert stamped and all(s.startswith("candidate:") for s in stamped)


def test_irv2_group_digests():
    """Inception-ResNet-v2's residuals form one group per block with
    four digests (block35, block17, block8, b8_final), equal to the JAX
    package's, and `group_digest` recomputes each stamp."""
    from mxnet_tpu_torch.passes import codegen as cg
    from mxnet_tpu_torch.passes.ir import Graph

    a, b, _ = _pair("irv2")
    digests = [s for _, _, s in _stamps(tmx.passes.optimize(b)) if s]
    assert len(digests) == 4 and len(set(digests)) == 4
    assert digests == [s for _, _, s in _stamps(jmx.passes.optimize(a))
                       if s]
    graph = Graph.from_symbol(tmx.passes.optimize(b))
    for tag, members in sorted(cg._groups_in(graph.nodes).items()):
        spec, ext = cg._group_spec(graph.nodes, sorted(members))
        stamp = graph.nodes[sorted(members)[-1]].extra["__fusion_codegen__"]
        assert stamp == f"candidate:{cg.group_digest(spec, len(ext))}"


def test_full_depth_irv2_has_forty_groups():
    """At full depth: 39 scale_bias_act residuals and the elementwise
    b8_final residual, four digests; 55,889,224 parameters at 1000
    classes (3x299x299)."""
    tbase._name_counters.clear()
    net = tmx.models.get_inception_resnet_v2(num_classes=1000)
    stamps = [s for _, _, s in _stamps(tmx.passes.optimize(net)) if s]
    assert len(stamps) == 40 and len(set(stamps)) == 4
    args, _, _ = net.infer_shape(data=(1, 3, 299, 299))
    names = net.list_arguments()
    n = sum(int(np.prod(s)) for nm, s in zip(names, args)
            if nm not in ("data", "softmax_label"))
    assert n == 55_889_224
