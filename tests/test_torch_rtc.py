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
  tensors raise), PallasKernel and MXRtc refusals, the launch geometry
  (with the grid-stride cap).
- The launcher's host path without a card, through a stand-in driver
  whose cuLaunchKernel records what it is given: the parameter block
  holds what the per-argument ctypes objects held before (pointers, then
  n), each arity's block is the thread's own and reused, and the
  per-thread context check (no context call once a thread holds the
  primary context; a thread with none keeps it; another context is
  restored after each launch; a launch refused for its context is
  retried once through the check), and eight threads launching at once
  under a short switch interval (each launch carries its own thread's
  pointers; no count is lost).
- The head's geometry from the row length: block and path at each
  boundary where they change, and the constants the CUDA source
  shares with rtc_ops.
- The rtc_softmax_ce head's plain versions against torch.softmax and
  SoftmaxOutput's gradient (1e-6: the two softmaxes sum in another
  order), and the
  head in a graph through the Executor on the CPU against SoftmaxOutput's
  (outputs 1e-6, gradients 1e-6) and against the JAX package's numpy
  softmax-CE CustomOp of examples/numpy_ops/custom_softmax.py (1e-6).
"""
import ctypes
import importlib.util
import os
import re
import sys
import threading

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
    (-1, None), (None, (32, 33)), ((2, -1), None)])
def test_launch_geometry_refusals(grid, block):
    with pytest.raises(MXNetError):
        rtc.launch_geometry(100, grid, block)


@pytest.mark.parametrize("n, grid, block, items, want", [
    # a grid-stride kernel that moves 16 elements a thread a pass: its
    # default grid is ceil(n / (threads * 16)) ...
    (1 << 26, None, None, 16, ((16384, 1, 1), (256, 1, 1))),
    ((1 << 20) + 3, None, None, 16, ((257, 1, 1), (256, 1, 1))),
    (1 << 26, None, 1024, 16, ((4096, 1, 1), (1024, 1, 1))),
    (5, None, 64, 16, ((1, 1, 1), (64, 1, 1))),
    (0, None, None, 16, ((0, 1, 1), (256, 1, 1))),
    # ... and a grid the caller gives is taken as it is
    (1 << 26, 5000, None, 16, ((5000, 1, 1), (256, 1, 1))),
])
def test_launch_geometry_items_per_thread(n, grid, block, items, want):
    assert rtc.launch_geometry(n, grid, block, items) == want


def test_sources_define_their_entry_points():
    for fn in rtc_ops._FILE_OF:
        k = rtc_ops.kernel(fn)
        assert k.fn_name == fn and f"void {fn}(" in k.source
        assert rtc_ops.kernel(fn) is k
        # the elementwise bodies loop with a grid stride; the head's
        # kernels take one CTA a row and their grid is given
        assert k.items_per_thread == (rtc_ops.ELEMENTWISE_ITEMS
                                      if fn.startswith(("double", "scale",
                                                        "saxpy")) else 1)
        assert k.build_log is None or "ptxas" in k.build_log


# --------------------------------------------------- the launcher's host path
PRIMARY, OTHER, FN, STREAM = 0xC0, 0xD0, 0x1234, 0x5150


class _FakeDriver:
    """Stands in for libcuda: records every launch (its arguments, with
    the 8-byte values the parameter block points at, read at the call
    as the driver copies them) and every context call."""

    def __init__(self, current=PRIMARY, fail_first=None):
        self.current, self.fail_first = current, fail_first
        self.launches, self.ctx_calls = [], []

    @staticmethod
    def _values(params):
        return [ctypes.c_uint64.from_address(params[i]).value
                for i in range(len(params))]

    def cuLaunchKernel(self, fn, gx, gy, gz, bx, by, bz, shared, stream,
                       params, extra):
        self.launches.append({
            "fn": fn.value, "grid": (gx, gy, gz), "block": (bx, by, bz),
            "shared": shared, "stream": stream, "extra": extra,
            "values": self._values(params), "context": self.current})
        if self.fail_first is not None:
            res, self.fail_first = self.fail_first, None
            return res
        return 0

    def cuCtxGetCurrent(self, ref):
        self.ctx_calls.append(("get",))
        ref._obj.value = self.current or None
        return 0

    def cuCtxSetCurrent(self, ctx):
        self.ctx_calls.append(("set", ctx.value))
        self.current = ctx.value
        return 0

    def cuGetErrorName(self, res, ref):
        return 0

    def cuGetErrorString(self, res, ref):
        return 0


def _fake_kernel(driver, fn="saxpy_f32"):
    k = _kernel(fn)
    k._targets[0] = rtc._Target(0, ctypes.c_void_p(FN),
                                ctypes.c_void_p(PRIMARY), driver,
                                lambda index: STREAM, tmx.gpu(0))
    return k


def _in_thread(fn):
    """Run fn in a fresh thread (its own thread-local state)."""
    out, errors = [], []

    def run():
        try:
            out.append(fn())
        except Exception as e:       # reported by the assertion below
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join(60)
    assert not th.is_alive()
    if errors:
        raise errors[0]
    return out[0]


@pytest.fixture
def keep_stats():
    """The process's rtc counters as they were before the test (the
    stand-in launches count like real ones)."""
    before = dict(rtc._stats)
    yield
    rtc._stats.update(before)


_CUDA0 = torch.device("cuda", 0)


@pytest.mark.usefixtures("keep_stats")
def test_parameter_block_packs_what_the_ctypes_objects_held():
    x, y, out = torch.ones(6), torch.ones(6), torch.empty(6)
    drv = _FakeDriver()
    k = _fake_kernel(drv)

    def launch():
        before = (k.launches, rtc.stats()["launches"])
        k._launch(_CUDA0, [x, y], [out], None, None)
        k._launch(_CUDA0, [y, x], [out], (3, 2), (32, 2))
        return before

    before = _in_thread(launch)
    # what _launch packed before: one ctypes object an argument, then an
    # array of their addresses
    objs = [ctypes.c_void_p(t.data_ptr()) for t in (x, y, out)] \
        + [ctypes.c_int64(6)]
    old = (ctypes.c_void_p * 4)(*[ctypes.addressof(v) for v in objs])
    want = _FakeDriver._values(old)
    assert want == [x.data_ptr(), y.data_ptr(), out.data_ptr(), 6]
    first, second = drv.launches
    assert first["values"] == want
    assert second["values"] == [y.data_ptr(), x.data_ptr(),
                                out.data_ptr(), 6]
    assert first["fn"] == FN and first["stream"] == STREAM
    assert first["shared"] == 0 and first["extra"] is None
    assert first["grid"] == (1, 1, 1) and first["block"] == (256, 1, 1)
    assert second["grid"] == (3, 2, 1) and second["block"] == (32, 2, 1)
    assert k.launches == before[0] + 2


@pytest.mark.usefixtures("keep_stats")
def test_grid_stride_kernels_take_the_smaller_grid():
    drv = _FakeDriver()
    k = _fake_kernel(drv, "double_f32")
    k.items_per_thread = 16
    x = torch.ones(100_000)
    _in_thread(lambda: k._launch(_CUDA0, [x], [x], None, None))
    assert drv.launches[0]["grid"] == (25, 1, 1)     # ceil(1e5 / 4096)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 9])
def test_parameter_block_per_arity(count):
    def block():
        vals, params, pack = rtc._param_block(count)
        pack(vals, 0, *range(100, 100 + count))
        # the driver reads the value each address points at
        return (vals, params, _FakeDriver._values(params),
                rtc._param_block(count)[0] is vals)

    vals, params, got, reused = _in_thread(block)
    assert len(params) == count and got == list(range(100, 100 + count))
    assert [params[i] for i in range(count)] == [
        ctypes.addressof(vals) + 8 * i for i in range(count)]
    assert reused                    # one block an arity, kept by the thread
    # another thread packs into a block of its own
    assert ctypes.addressof(_in_thread(block)[0]) != ctypes.addressof(vals)


def _three_pushes(drv):
    k = _fake_kernel(drv)
    x = torch.ones(8)
    for _ in range(3):
        k._launch(_CUDA0, [x, x], [x], None, None)
    return getattr(rtc._tls, "ctx", None)


@pytest.mark.usefixtures("keep_stats")
def test_context_checked_once_a_thread():
    drv = _FakeDriver(current=PRIMARY)
    assert _in_thread(lambda: _three_pushes(drv)) == 0
    assert drv.ctx_calls == [("get",)]          # once, then none
    assert [c["context"] for c in drv.launches] == [PRIMARY] * 3
    # a second thread checks for itself
    _in_thread(lambda: _three_pushes(drv))
    assert drv.ctx_calls == [("get",)] * 2


@pytest.mark.usefixtures("keep_stats")
def test_thread_without_a_context_keeps_the_primary_one():
    drv = _FakeDriver(current=None)
    assert _in_thread(lambda: _three_pushes(drv)) == 0
    assert drv.ctx_calls == [("get",), ("set", PRIMARY)]
    assert [c["context"] for c in drv.launches] == [PRIMARY] * 3


@pytest.mark.usefixtures("keep_stats")
def test_thread_with_another_context_gets_it_back():
    drv = _FakeDriver(current=OTHER)
    assert _in_thread(lambda: _three_pushes(drv)) is None
    assert drv.ctx_calls == [("get",), ("set", PRIMARY),
                             ("set", OTHER)] * 3
    assert [c["context"] for c in drv.launches] == [PRIMARY] * 3
    assert drv.current == OTHER


@pytest.mark.usefixtures("keep_stats")
def test_launch_refused_for_its_context_is_checked_and_retried():
    drv = _FakeDriver(current=PRIMARY)
    k = _fake_kernel(drv)
    x = torch.ones(8)

    def run():
        k._launch(_CUDA0, [x, x], [x], None, None)   # marks the thread
        drv.fail_first = 201           # CUDA_ERROR_INVALID_CONTEXT
        before = k.launches
        k._launch(_CUDA0, [x, x], [x], None, None)
        return k.launches - before

    assert _in_thread(run) == 1
    assert len(drv.launches) == 3 and drv.ctx_calls == [("get",)] * 2
    drv.fail_first = 719               # any other error is raised
    with pytest.raises(MXNetError, match="CUDA error 719"):
        _in_thread(lambda: k._launch(_CUDA0, [x, x], [x], None, None))


@pytest.mark.usefixtures("keep_stats")
def test_threads_keep_their_own_parameter_blocks():
    # more threads than cores and a short switch interval: every launch
    # carries its own thread's pointers, and no count is lost
    drv = _FakeDriver()
    k = _fake_kernel(drv)
    tensors = [torch.ones(8) for _ in range(8)]
    before = (k.launches, rtc.stats()["launches"])
    errors, interval = [], sys.getswitchinterval()

    def run(x):
        try:
            for _ in range(200):
                k._launch(_CUDA0, [x, x], [x], None, None)
        except Exception as e:       # reported by the assertion below
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(x,))
                   for x in tensors]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    assert k.launches - before[0] == 1600
    assert rtc.stats()["launches"] - before[1] == 1600
    ptrs = {x.data_ptr() for x in tensors}
    assert all(c["values"][:3] == [c["values"][0]] * 3
               and c["values"][0] in ptrs and c["values"][3] == 8
               for c in drv.launches)


def test_zero_size_push_compiles_and_launches_nothing():
    k = _kernel()
    x = torch.ones(0)
    assert k._launch(_CUDA0, [x], [x], None, None) is None
    assert k._digest is None and k.launches == 0 and not k._targets


# ------------------------------------------------------- the head's geometry
@pytest.mark.parametrize("cols, want", [
    # one float4 a thread, one CTA of at least a warp, up to 4096 floats
    (1, (32, "registers")), (31, (32, "registers")),
    (32, (32, "registers")), (33, (32, "registers")),
    (128, (32, "registers")), (129, (64, "registers")),
    (1000, (256, "registers")), (1024, (256, "registers")),
    (1025, (512, "registers")), (4095, (1024, "registers")),
    (4096, (1024, "registers")),
    # then SOFTMAX_VEC float4s a thread (32 floats), rows of a multiple
    # of 4 floats only
    (4100, (256, "registers")), (8192, (256, "registers")),
    (8196, (512, "registers")), (16384, (512, "registers")),
    (16388, (1024, "registers")), (32000, (1024, "registers")),
    (32768, (1024, "registers")),
    # past 4 floats a thread, other lengths load scalars and stream twice
    (4097, (1024, "online")), (4098, (1024, "online")),
    (8193, (1024, "online")), (32001, (1024, "online")),
    # past one 1024-thread CTA's registers: the row streams twice
    (32772, (1024, "online")), (65536, (1024, "online")),
    (65537, (1024, "online")), (131072, (1024, "online")),
    (131073, (1024, "online")), (1 << 24, (1024, "online")),
])
def test_softmax_geometry(cols, want):
    assert rtc_ops.softmax_geometry(cols) == want
    block, path = want
    in_registers = cols <= 4 * block or (
        cols % 4 == 0 and cols <= 4 * rtc_ops.SOFTMAX_VEC * block)
    assert in_registers == (path == "registers")
    assert block % 32 == 0 and block <= rtc_ops.SOFTMAX_MAX_BLOCK


@pytest.mark.parametrize("cols, want", [
    (1, 256), (1000, 256), (8192, 256), (8193, 512), (16384, 512),
    (16385, 1024), (32000, 1024), (65536, 1024), (1 << 20, 1024)])
def test_softmax_backward_block(cols, want):
    assert rtc_ops.softmax_backward_block(cols) == want


def test_cuda_sources_share_the_constants():
    with open(rtc_ops.source_path("softmax_ce_forward")) as f:
        src = f.read()
    with open(rtc_ops.source_path("double_f32")) as f:
        src_ew = f.read()
    for name, text in (("SOFTMAX_VEC", src), ("BWD_UNROLL", src),
                       ("EW_UNROLL", src_ew)):
        (value,) = re.findall(rf"#define {name} (\d+)", text)
        assert int(value) == getattr(rtc_ops, name), name
    # the forward's __launch_bounds__ admits every block the head picks
    (bound,) = set(re.findall(r"__launch_bounds__\((\d+)\)", src))
    assert int(bound) >= rtc_ops.SOFTMAX_MAX_BLOCK


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
