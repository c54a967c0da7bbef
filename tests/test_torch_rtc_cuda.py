"""User device code through rtc.CudaKernel (NVRTC, sm_90a) on the card,
against the plain PyTorch versions in rtc_ops. Marked `cuda`: these skip
where torch.cuda.is_available() is false (CUDA source has no CPU mode).
This file imports neither jax nor mxnet_tpu, so it runs on a machine with
only the port installed:

    python -m pytest tests/test_torch_rtc_cuda.py -q

Tolerances: the elementwise kernels agree bit for bit (no FMA
contraction; bf16 rounds to nearest even and int32 truncates, as torch's
casts); the softmax backward agrees bit for bit given the same prob; the
softmax forward agrees within 1e-6 absolute (its sums run in another
order; every value is at most 1).
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc, rtc_ops
from mxnet_tpu_torch.base import MXNetError

pytestmark = pytest.mark.cuda

SOFTMAX_TOL = 1e-6
PLAIN = {"double": (rtc_ops.double_plain, 1),
         "scale_shift": (rtc_ops.scale_shift_plain, 1),
         "saxpy": (rtc_ops.saxpy_plain, 2)}
CASTS = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA source has no CPU mode)")
    return torch.device("cuda")


def _randn(shape, seed, scale=100.0, dev="cuda"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dev)


@pytest.mark.parametrize("n", [1, 255, 257, 100_003, 1 << 20])
@pytest.mark.parametrize("kind", sorted(CASTS))
@pytest.mark.parametrize("body", sorted(PLAIN))
def test_elementwise_against_plain(dev, body, kind, n):
    plain, n_in = PLAIN[body]
    ins = [_randn((n,), seed) for seed in range(n_in)]
    k = rtc_ops.kernel(f"{body}_{kind}")
    before = k.launches
    (out,) = k.push(ins, out_shapes=[(n,)], out_dtypes=[CASTS[kind]])
    torch.cuda.synchronize()
    assert out.data.dtype == CASTS[kind] and out.context == mx.gpu(0)
    assert torch.equal(out.data, plain(*ins).to(CASTS[kind]))
    assert k.launches == before + 1


def test_grid_stride_and_push_into(dev):
    x = _randn((10_000,), 3)
    k = rtc_ops.kernel("scale_shift_f32")
    out = torch.empty_like(x)
    k.push_into([x], [out], grid=1, block=32)    # one block walks all
    torch.cuda.synchronize()
    assert torch.equal(out, rtc_ops.scale_shift_plain(x))
    nd_out = mx.nd.NDArray(torch.zeros_like(x))
    k.push_into([mx.nd.NDArray(x)], [nd_out], grid=(3, 1), block=(64,))
    assert torch.equal(nd_out.data, rtc_ops.scale_shift_plain(x))
    before = k.launches
    (empty,) = k.push([x[:0]], out_shapes=[(0,)])
    assert empty.shape == (0,) and k.launches == before   # nothing to run


@pytest.mark.parametrize("rows, cols", [(32, 1000), (8, 33), (3, 1),
                                        (4, 32000), (1, 4097)])
def test_softmax_against_plain(dev, rows, cols):
    x = _randn((rows, cols), rows * cols, scale=5.0)
    prob = rtc_ops.softmax_ce_forward(x)
    torch.cuda.synchronize()
    ref = rtc_ops.softmax_plain(x)
    assert (prob - ref).abs().max().item() <= SOFTMAX_TOL
    torch.testing.assert_close(prob.sum(1), torch.ones(rows, device=dev))
    g = torch.Generator().manual_seed(cols)
    label = torch.randint(0, cols, (rows,), generator=g).float().to(dev)
    label[0] = -1.0 if rows > 1 else label[0]        # subtracts nothing
    grad = rtc_ops.softmax_ce_backward(prob, label)
    torch.cuda.synchronize()
    assert torch.equal(grad, rtc_ops.softmax_ce_backward_plain(prob, label))


def test_softmax_misaligned_rows_take_the_scalar_path(dev):
    flat = _randn((1 + 6 * 64,), 9, scale=3.0)
    x = flat[1:].view(6, 64)              # contiguous, 4 bytes off 16
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    prob = rtc_ops.softmax_ce_forward(x)
    assert (prob - rtc_ops.softmax_plain(x)).abs().max().item() \
        <= SOFTMAX_TOL


def test_compile_once_and_cache_hits(dev):
    with open(rtc_ops.source_path("double_f32")) as f:
        src = f.read()
    a = rtc.CudaKernel("a", src, "double_f32")
    x = _randn((1000,), 1)
    a.push([x], [(1000,)])
    stats = rtc.stats()
    b = rtc.CudaKernel("b", src, "double_i32")
    b.push([x], [(1000,)], out_dtypes=[torch.int32])
    after = rtc.stats()
    # the second kernel of the same source takes the cached cubin
    assert after["compiles"] == stats["compiles"]
    assert after["cache_hits"] == stats["cache_hits"] + 1
    assert b.compile_ms is None
    assert after["launches"] == stats["launches"] + 1


def test_compile_time_of_a_new_source(dev):
    src = ('extern "C" __global__ void add_one(const float* x, float* o,'
           ' long long n) { long long i = blockIdx.x * (long long)'
           'blockDim.x + threadIdx.x; if (i < n) o[i] = x[i] + 1.0f; }'
           f'\n// {np.random.randint(1 << 30)}')   # a digest not built yet
    k = rtc.CudaKernel("add_one", src, "add_one")
    before = rtc.stats()["compiles"]
    cubin = k.compile()
    assert cubin[:4] == b"\x7fELF" and k.compile_ms > 0
    assert rtc.stats()["compiles"] == before + 1
    x = _randn((77,), 2)
    (y,) = k.push([x], [(77,)])
    assert torch.equal(y.data, x + 1.0)


def test_push_off_the_main_thread(dev):
    x = _randn((4096,), 5)
    results, errors = [], []

    def run():
        try:
            (y,) = rtc_ops.kernel("double_f32").push([x], [x.shape])
            torch.cuda.synchronize()
            results.append(y.data)
        except Exception as e:       # reported by the assertion below
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join(120)
    assert not th.is_alive() and not errors, errors
    assert torch.equal(results[0], x * 2.0)


def test_nvrtc_error_carries_the_log(dev):
    bad = ('extern "C" __global__ void broken(float* o, long long n) '
           '{ o[0] = undefined_name; }')
    with pytest.raises(MXNetError, match="undefined_name"):
        rtc.CudaKernel("broken", bad, "broken").push(
            [torch.zeros(1, device=dev)], [(1,)])


def test_mangled_function_refused(dev):
    src = '__global__ void plain_cpp(const float* x, float* o, long long n) {}'
    with pytest.raises(MXNetError, match='extern "C"'):
        rtc.CudaKernel("m", src, "plain_cpp").push(
            [torch.zeros(1, device=dev)], [(1,)])


def test_refusals_on_the_card(dev):
    k = rtc_ops.kernel("saxpy_f32")
    x = torch.ones(8, 4, device=dev)
    with pytest.raises(MXNetError, match="not contiguous"):
        k.push([x.t(), x.t()], [(4, 8)])
    with pytest.raises(MXNetError, match="different devices"):
        k.push([x, torch.ones(8, 4)], [(8, 4)])
    with pytest.raises(MXNetError, match="threads"):
        k.push([x, x], [(8, 4)], block=2048)


def _head_net(op_type):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, name="fc1", num_hidden=64)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=1000)
    if op_type is None:
        return mx.sym.SoftmaxOutput(net, name="softmax")
    return mx.sym.Custom(data=net, label=mx.sym.Variable("softmax_label"),
                         op_type=op_type, name="softmax")


def test_custom_head_module_step_against_softmax_output(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(0)
    x = rs.randn(32, 100).astype(np.float32)
    y = rs.randint(0, 1000, 32).astype(np.float32)
    batch = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])
    results = []
    for op_type in ("rtc_softmax_ce", None):
        mod = mx.mod.Module(_head_net(op_type), context=mx.gpu(0))
        mod.bind(data_shapes=[("data", (32, 100))],
                 label_shapes=[("softmax_label", (32,))])
        mx.random.seed(0)
        mod.init_params(initializer=mx.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        before = rtc.stats()["launches"]
        mod.forward_backward(batch)
        torch.cuda.synchronize()
        launches = rtc.stats()["launches"] - before
        exe = mod._exec_group.execs[0]
        results.append((launches, exe.outputs[0].data.clone(),
                        {n: exe.grad_dict[n].data.clone()
                         for n in ("fc1_weight", "fc2_weight", "fc2_bias")}))
        mod.update()
    (l_rtc, out_rtc, g_rtc), (l_ref, out_ref, g_ref) = results
    assert (l_rtc, l_ref) == (2, 0)
    assert (out_rtc - out_ref).abs().max().item() <= 1e-5 * out_ref.abs().max().item()
    for n, g in g_ref.items():
        assert (g_rtc[n] - g).abs().max().item() <= 1e-5 * g.abs().max().item(), n
