"""User device code through rtc.CudaKernel (NVRTC, sm_90a) on the card,
against the plain PyTorch versions in rtc_ops. Marked `cuda`: these skip
where torch.cuda.is_available() is false (CUDA source has no CPU mode).
This file imports neither jax nor mxnet_tpu, so it runs on a machine with
only the port installed:

    python -m pytest tests/test_torch_rtc_cuda.py -q

Tolerances: the elementwise kernels agree bit for bit (no FMA
contraction; bf16 rounds to nearest even and int32 truncates, as torch's
casts), on the 16-byte path, its scalar tail and misaligned views; the
softmax backward agrees bit for bit given the same prob; the softmax
forward agrees within 1e-6 absolute on every path (its sums run in
another order, and the online path rescales its running sums; every
value is at most 1), at each row length where the head's geometry
changes (one warp, one float4 a thread, SOFTMAX_VEC of them, the online
path) and at blocks a push may give the vocabulary-sized row.
"""
import re
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


def _head_case(rows, cols, seed, dev, x=None):
    """Forward and backward of the head on (rows, cols) against the plain
    versions; labels include -1 (subtracts nothing), the last column and
    a truncated fraction."""
    if x is None:
        x = _randn((rows, cols), seed, scale=5.0)
    prob = rtc_ops.softmax_ce_forward(x)
    torch.cuda.synchronize()
    err = (prob - rtc_ops.softmax_plain(x)).abs().max().item()
    assert err <= SOFTMAX_TOL, (rows, cols, err)
    torch.testing.assert_close(prob.sum(1), torch.ones(rows, device=dev))
    g = torch.Generator().manual_seed(seed)
    label = torch.randint(0, cols, (rows,), generator=g).float()
    label[0] = cols - 1
    if rows > 1:
        label[1] = -1.0
    if rows > 2:
        label[2] = min(cols - 1, 2) + 0.75
    label = label.to(dev)
    grad = rtc_ops.softmax_ce_backward(prob, label)
    torch.cuda.synchronize()
    assert torch.equal(grad, rtc_ops.softmax_ce_backward_plain(prob, label))
    return prob


# each boundary of softmax_geometry, and one past it
@pytest.mark.parametrize("cols", [1, 31, 32, 33, 128, 129, 1000, 1024,
                                  1025, 4096, 4097, 4100, 32000, 32768,
                                  32769, 32772, 65536, 65537, 131072,
                                  131073, 600_001])
def test_softmax_paths_against_plain(dev, cols):
    rows = 5 if cols < 1 << 16 else 3
    _head_case(rows, cols, cols, dev)


def test_softmax_vocabulary_shape(dev):
    _head_case(8192, 32000, 7, dev)


# blocks at the vocabulary width: registers (1024) and online (the rest,
# 992 a block of 31 warps)
@pytest.mark.parametrize("block", [1024, 992, 512, 256, 128, 96, 64, 32])
def test_softmax_any_geometry_at_vocabulary_width(dev, block):
    x = _randn((16, 32000), block, scale=5.0)
    prob = torch.empty_like(x)
    k = rtc_ops.kernel("softmax_ce_forward")
    before = k.launches
    k.push_into([x], [prob], grid=16, block=block)
    torch.cuda.synchronize()
    assert (prob - rtc_ops.softmax_plain(x)).abs().max().item() \
        <= SOFTMAX_TOL
    assert k.launches == before + 1


def test_softmax_online_path_rescales_a_rising_row(dev):
    # a rising row makes the running max grow at every chunk
    cols = 300_000
    x = torch.linspace(-30.0, 30.0, cols, device=dev).repeat(2, 1)
    x[1] = x[1].flip(0)
    assert rtc_ops.softmax_geometry(cols)[1] == "online"
    _head_case(2, cols, 3, dev, x=x)


@pytest.mark.parametrize("cols", [32001, 70001, 131075])
def test_softmax_misaligned_long_rows(dev, cols):
    # rows of odd length start off 16 bytes: scalar loads, on the online
    # path
    _head_case(3, cols, cols, dev)
    flat = _randn((1 + 2 * cols,), cols, scale=5.0)
    x = flat[1:].view(2, cols)
    _head_case(2, cols, cols, dev, x=x)


def test_head_kernels_build_without_spills(dev):
    k = rtc_ops.kernel("softmax_ce_forward")
    k.compile()
    log = k.build_log
    for fn in ("softmax_ce_forward", "softmax_ce_backward"):
        part = log[log.index(f"entry function '{fn}'"):]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      part)
        regs = int(re.search(r"Used (\d+) registers", part).group(1))
        assert m.groups() == ("0", "0") and regs <= 64, (fn, part[:400])


@pytest.mark.parametrize("n", [1, 3, 4, 5, (1 << 20) + 3])
@pytest.mark.parametrize("kind", sorted(CASTS))
@pytest.mark.parametrize("body", sorted(PLAIN))
def test_elementwise_tails_and_misaligned_views(dev, body, kind, n):
    plain, n_in = PLAIN[body]
    k = rtc_ops.kernel(f"{body}_{kind}")
    ins = [_randn((n,), 10 + seed) for seed in range(n_in)]
    (out,) = k.push(ins, out_shapes=[(n,)], out_dtypes=[CASTS[kind]])
    torch.cuda.synchronize()
    assert torch.equal(out.data, plain(*ins).to(CASTS[kind]))
    # inputs 4 bytes off 16, then an output one element off its quad
    views = [_randn((n + 1,), 20 + seed)[1:] for seed in range(n_in)]
    assert views[0].data_ptr() % 16 == 4
    base = torch.zeros(n + 1, dtype=CASTS[kind], device=dev)
    k.push_into(views, [base[1:]])
    assert torch.equal(base[1:], plain(*views).to(CASTS[kind]))
    out = torch.zeros(n, dtype=CASTS[kind], device=dev)
    k.push_into(ins, [out], grid=3, block=64)      # any grid covers n
    assert torch.equal(out, plain(*ins).to(CASTS[kind]))


def test_pushes_from_many_threads(dev):
    x = _randn((1 << 16,), 6)
    k = rtc_ops.kernel("scale_shift_f32")
    want = rtc_ops.scale_shift_plain(x)
    before = k.launches
    errors = []

    def run():
        try:
            for _ in range(50):
                (y,) = k.push([x], [x.shape])
                torch.cuda.synchronize()
                assert torch.equal(y.data, want)
        except Exception as e:       # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors, errors
    assert k.launches == before + 200


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
