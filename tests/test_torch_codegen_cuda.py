"""The generated fusion kernels (mxnet_tpu_torch.passes.codegen) on the
card. Marked `cuda`: these skip where torch.cuda.is_available() is false
(the kernels have no CPU mode). This file does not import jax, so it
runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_codegen_cuda.py -q

Each template is held against its plain version (parity_error's
tolerances) in float32, bf16 and fp16; a bind on the card launches the
kernels; and an nvcc, launch or parity failure raises MXNetError rather
than falling back to the plain version.
"""
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.passes import codegen as cg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the generated kernels have no CPU "
                    "mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXNET_GRAPH_PASSES", "MXNET_FUSION_CODEGEN",
                "MXNET_FUSION_MIN_GROUP"):
        monkeypatch.delenv(var, raising=False)
    mx.passes.clear_memo()
    mx.passes.reset_fusion_stats()
    mx.passes.reset_launch_counts()
    yield
    mx.passes.clear_memo()
    mx.passes.reset_fusion_stats()


def _elementwise():
    x = mx.sym.Variable("x")
    return mx.sym.square(mx.sym.sigmoid(x)) * 0.5


def _scale_bias_act():
    x, g, b = (mx.sym.Variable(n) for n in ("x", "g", "b"))
    return mx.sym.Activation(
        mx.sym.elemwise_add(mx.sym.elemwise_mul(x, g), b), act_type="tanh")


def _reduction():
    x, y = mx.sym.Variable("x"), mx.sym.Variable("y")
    return mx.sym.sum(mx.sym.relu(x) * y)


def _block35():
    net, proj = mx.sym.Variable("net"), mx.sym.Variable("proj")
    return mx.sym.Activation(net + proj * 0.17, act_type="relu")


NETS = {"elementwise": _elementwise, "scale_bias_act": _scale_bias_act,
        "reduction": _reduction, "block35": _block35}
SHAPES = [(8, 128), (5, 7), (3, 1000, 37)]


def _bound_group(name, shape, device):
    sym = NETS[name]()
    exe = sym.simple_bind(mx.gpu(0), **{n: shape
                                        for n in sym.list_arguments()})
    (group, ext), = exe._codegen_plan.fused.values()
    return exe, group


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("shape", SHAPES, ids=["8x128", "5x7", "3x1000x37"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["float32", "bf16", "fp16"])
def test_kernel_matches_plain(cuda_device, name, shape, dtype):
    _, group = _bound_group(name, shape, cuda_device)
    grp = cg.build_groups([(group.spec, [(s, dtype)
                                         for s, _ in group.in_avals])],
                          cuda_device)[0]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ins = [torch.randn(s, generator=g, device=cuda_device).to(dtype)
           for s, _ in grp.in_avals]
    out = grp.kernel(*ins, out_shape=grp.out_shape, count=False)
    torch.cuda.synchronize()
    err, ok = cg.parity_error(grp, ins, out)
    assert ok, err
    assert out.dtype == dtype and tuple(out.shape) == grp.out_shape


@pytest.mark.cuda
def test_unaligned_inputs_take_the_scalar_path(cuda_device):
    _, group = _bound_group("block35", (4, 33), cuda_device)
    base = torch.randn(2, 4 * 33 + 1, device=cuda_device)
    ins = [base[i, 1:].reshape(4, 33) for i in range(2)]
    assert all(x.data_ptr() % 16 for x in ins)
    out = group.kernel(*ins, out_shape=group.out_shape, count=False)
    torch.cuda.synchronize()
    assert cg.parity_error(group, ins, out)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
def test_bind_on_card_launches_and_matches_op_by_op(cuda_device, name,
                                                    monkeypatch):
    shape = (64, 96)
    sym = NETS[name]()
    g = torch.Generator(device=cuda_device).manual_seed(1)
    vals = {n: torch.rand(shape, generator=g, device=cuda_device) + 0.5
            for n in sym.list_arguments()}
    res = {}
    for codegen in ("0", "1"):
        monkeypatch.setenv("MXNET_FUSION_CODEGEN", codegen)
        mx.passes.clear_memo()
        exe = sym.simple_bind(mx.gpu(0), **{n: shape for n in vals})
        mx.passes.reset_launch_counts()
        exe.forward(is_train=True, **vals)
        exe.backward()
        torch.cuda.synchronize()
        res[codegen] = ([o.data.clone() for o in exe.outputs],
                        {n: exe.grad_dict[n].data.clone() for n in vals},
                        sum(mx.passes.launch_counts().values()))
    assert res["0"][2] == 0 and res["1"][2] == 1
    for a, b in zip(res["0"][0], res["1"][0]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    for n in vals:
        torch.testing.assert_close(res["1"][1][n], res["0"][1][n],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_nvcc_failure_raises(cuda_device, monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "GEN_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "nvcc_path", lambda: "/bin/false")
    with pytest.raises(MXNetError, match="nvcc failed"):
        _bound_group("elementwise", (8, 128), cuda_device)


@pytest.mark.cuda
def test_parity_failure_raises(cuda_device, monkeypatch):
    monkeypatch.setitem(cg._EXPR, "elemwise_add",
                        cg._fmt("({0} + {1} + 1.f)"))
    with pytest.raises(MXNetError, match="disagrees with its plain"):
        _bound_group("scale_bias_act", (8, 128), cuda_device)
    assert mx.passes.fusion_stats()["parity_failures"] == 1


@pytest.mark.cuda
def test_launch_failure_raises(cuda_device, monkeypatch):
    _, group = _bound_group("elementwise", (8, 128), cuda_device)
    monkeypatch.setattr(group.kernel, "_entry", lambda *a: 9)
    x = torch.randn(8, 128, device=cuda_device)
    with pytest.raises(MXNetError, match="launch failed"):
        group(x)
    assert group.kernel.launches == 0
