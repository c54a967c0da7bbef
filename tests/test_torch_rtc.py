"""User device code (rtc) in the port, on the CPU.

- The JAX package's Pallas bodies of the repo's rtc examples (double,
  scale_shift, saxpy), run by its PallasKernel in interpret mode, against
  the port's plain versions of the same kernels (rtc_ops), which the CUDA
  kernels of csrc/rtc/elementwise.cu are held to bit for bit on the card.
  double and scale_shift agree bit for bit. saxpy does not: XLA's CPU
  backend contracts 2.5 * x + y into one fused multiply-add (one
  rounding; the test shows the JAX result equal to it bit for bit), while
  the plain version rounds after the multiply and after the add, as
  torch's two ops and the CUDA kernel's __fmul_rn/__fadd_rn do; the two
  differ by at most half an ulp of the product 2.5 * x plus an ulp of
  the result.
- Every refusal of rtc.CudaKernel that the CPU can show (no fallback: CPU
  tensors raise), PallasKernel and MXRtc refusals, the launch geometry.
- The rtc_softmax_ce head's plain versions against torch.softmax and
  SoftmaxOutput's gradient (1e-6: the two softmaxes sum in another
  order), and the
  head in a graph through the Executor on the CPU against SoftmaxOutput's
  (outputs 1e-6, gradients 1e-6) and against the JAX package's numpy
  softmax-CE CustomOp of examples/numpy_ops/custom_softmax.py (1e-6).
"""
import importlib.util
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import rtc, rtc_ops  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _double(x_ref, o_ref):            # tests/test_feedforward_rtc.py:86-93
    o_ref[...] = x_ref[...] * 2.0


def _scale_shift(x_ref, o_ref):       # tests/test_capi_tier4.py:114-118
    o_ref[...] = x_ref[...] * 4.0 - 1.0


def _saxpy(x_ref, y_ref, o_ref):      # recordio_rtc.cc:54-57
    o_ref[...] = 2.5 * x_ref[...] + y_ref[...]


BODIES = {"double": (_double, rtc_ops.double_plain, 1),
          "scale_shift": (_scale_shift, rtc_ops.scale_shift_plain, 1),
          "saxpy": (_saxpy, rtc_ops.saxpy_plain, 2)}


@pytest.mark.parametrize("shape", [(8,), (37, 129), (4, 5, 6)])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_pallas_bodies_against_plain_versions(name, shape):
    body, plain, n_in = BODIES[name]
    rs = np.random.RandomState(len(shape))
    xs = [(rs.randn(*shape) * 100).astype(np.float32) for _ in range(n_in)]
    (got,) = jmx.rtc.PallasKernel(name, body).push(
        [jmx.nd.array(x) for x in xs], out_shapes=[shape])
    got = got.asnumpy()
    want = plain(*[torch.from_numpy(x) for x in xs]).numpy()
    assert got.dtype == want.dtype == np.float32
    if name == "saxpy":
        x, y = xs
        product = np.float32(2.5) * x
        np.testing.assert_array_equal(want, product + y)
        # the JAX body is the fused multiply-add: 2.5 * x exact in
        # float64, the sum rounded once (exact in float64 at these
        # magnitudes, then to float32)
        fused = (2.5 * x.astype(np.float64) + y).astype(np.float32)
        np.testing.assert_array_equal(got, fused)
        # so the two differ by at most half an ulp of the product (its
        # rounding) plus an ulp of the result (the two final roundings)
        bound = np.spacing(np.abs(product)) / 2 + np.spacing(
            np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= bound)
    else:
        np.testing.assert_array_equal(got, want)


def _kernel(fn="double_f32"):
    with open(rtc_ops.source_path(fn)) as f:
        return rtc.CudaKernel("k", f.read(), fn)


def test_cuda_kernel_refuses_cpu_tensors():
    rtc.reset_stats()
    k = _kernel()
    x = tmx.nd.array(np.ones(8, np.float32))
    with pytest.raises(MXNetError, match="CUDA source runs on the card"):
        k.push([x], out_shapes=[(8,)])
    with pytest.raises(MXNetError, match="CUDA source runs on the card"):
        k.push_into([x], [tmx.nd.zeros((8,), ctx=tmx.cpu())])
    # nothing was compiled or launched for a refused push
    assert rtc.stats() == {"launches": 0, "compiles": 0, "cache_hits": 0}
    assert k.launches == 0 and k.compile_ms is None


def test_cuda_kernel_refuses_bad_tensors():
    k = _kernel("saxpy_f32")
    x = torch.ones(4, 6)
    with pytest.raises(MXNetError, match="not contiguous"):
        k.push([x.t(), x.t()], out_shapes=[(6, 4)])
    with pytest.raises(MXNetError, match="different devices"):
        k.push([x, torch.empty(4, 6, device="meta")], out_shapes=[(4, 6)])
    with pytest.raises(MXNetError, match="NDArrays or tensors"):
        k.push([np.ones(3, np.float32)], out_shapes=[(3,)])


def test_cuda_kernel_needs_its_function():
    src = 'extern "C" __global__ void f(float* o, long long n) {}'
    rtc.CudaKernel("ok", src, "f")
    with pytest.raises(MXNetError, match="defines no __global__ function "
                       "'nope'"):
        rtc.CudaKernel("x", src, "nope")
    with pytest.raises(MXNetError, match="'f'"):
        rtc.CudaKernel("x", "void f(float* o) {}", "f")


def test_pallas_kernel_and_mxrtc_refused():
    with pytest.raises(MXNetError, match="CudaKernel"):
        rtc.PallasKernel("double", _double)
    with pytest.raises(MXNetError, match="CudaKernel"):
        rtc.MXRtc("x", [], [], "out[i] = x[i];")
    # the JAX package refuses MXRtc too
    with pytest.raises(jmx.MXNetError):
        jmx.rtc.MXRtc("x", [], [], "__global__ void x() {}")


@pytest.mark.parametrize("n, grid, block, want", [
    (1, None, None, ((1, 1, 1), (256, 1, 1))),
    (256, None, None, ((1, 1, 1), (256, 1, 1))),
    (257, None, None, ((2, 1, 1), (256, 1, 1))),
    (1 << 26, None, None, ((262144, 1, 1), (256, 1, 1))),
    (0, None, None, ((0, 1, 1), (256, 1, 1))),
    (1000, None, 128, ((8, 1, 1), (128, 1, 1))),
    (32000, 32, 256, ((32, 1, 1), (256, 1, 1))),
    (10, (2, 3), (4, 8, 2), ((2, 3, 1), (4, 8, 2))),
])
def test_launch_geometry(n, grid, block, want):
    assert rtc.launch_geometry(n, grid, block) == want


@pytest.mark.parametrize("grid, block", [
    (None, 2048), (None, (32, 32, 2)), (None, 0), ((1, 1, 1, 1), None),
    (-1, None)])
def test_launch_geometry_refusals(grid, block):
    with pytest.raises(MXNetError):
        rtc.launch_geometry(100, grid, block)


def test_sources_define_their_entry_points():
    for fn in rtc_ops._FILE_OF:
        k = rtc_ops.kernel(fn)
        assert k.fn_name == fn and f"void {fn}(" in k.source
        assert rtc_ops.kernel(fn) is k


# ------------------------------------------------------------ the head
def test_softmax_plain_versions():
    rs = np.random.RandomState(0)
    x = torch.from_numpy((rs.randn(32, 1000) * 5).astype(np.float32))
    label = torch.from_numpy(rs.randint(0, 1000, 32).astype(np.float32))
    label[3] = -1.0       # out of range: subtracts nothing
    label[4] = 999.7      # truncated toward zero
    prob = rtc_ops.softmax_plain(x)
    torch.testing.assert_close(prob, torch.softmax(x, dim=1), rtol=0,
                               atol=1e-6)
    grad = rtc_ops.softmax_ce_backward_plain(prob, label)
    # SoftmaxOutput's gradient with its defaults (its own softmax)
    leaf = x.clone().requires_grad_(True)
    out = tmx.ops.nn.softmax_output(leaf, label)
    out.backward(torch.ones_like(out))
    torch.testing.assert_close(grad, leaf.grad, rtol=0, atol=1e-6)
    assert torch.equal(grad[3], prob[3])
    assert grad[4, 999] == prob[4, 999] - 1.0


def _head_net(mx, op_type):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, name="fc1", num_hidden=32)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=10)
    if op_type is None:
        return mx.sym.SoftmaxOutput(net, name="softmax")
    return mx.sym.Custom(data=net, label=mx.sym.Variable("softmax_label"),
                         op_type=op_type, name="softmax")


def _head_step(mx, net, params, x, y, ctx):
    ex = net.simple_bind(ctx=ctx, data=x.shape, grad_req="write")
    for n, v in params.items():
        ex.arg_dict[n][:] = v
    out = ex.forward(is_train=True, data=x, softmax_label=y)[0].asnumpy()
    ex.backward()
    return out, {n: ex.grad_dict[n].asnumpy() for n in params}


def _head_inputs():
    rs = np.random.RandomState(5)
    x = rs.randn(16, 20).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.float32)
    params = {"fc1_weight": rs.randn(32, 20).astype(np.float32) * 0.3,
              "fc1_bias": rs.randn(32).astype(np.float32) * 0.1,
              "fc2_weight": rs.randn(10, 32).astype(np.float32) * 0.3,
              "fc2_bias": rs.randn(10).astype(np.float32) * 0.1}
    return x, y, params


def test_rtc_head_matches_softmax_output_and_the_jax_custom_op():
    x, y, params = _head_inputs()
    got = _head_step(tmx, _head_net(tmx, "rtc_softmax_ce"), params, x, y,
                     tmx.cpu())
    ref = _head_step(tmx, _head_net(tmx, None), params, x, y, tmx.cpu())
    spec = importlib.util.spec_from_file_location(
        "custom_softmax_example",
        os.path.join(ROOT, "examples", "numpy_ops", "custom_softmax.py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    jax_ref = _head_step(jmx, _head_net(jmx, "numpy_softmax_ce"), params,
                         x, y, jmx.cpu())
    for other in (ref, jax_ref):
        np.testing.assert_allclose(got[0], other[0], rtol=0, atol=1e-6)
        for n in params:
            np.testing.assert_allclose(got[1][n], other[1][n], rtol=0,
                                       atol=1e-6)
    assert rtc.stats()["launches"] == 0   # the CPU takes the plain versions
