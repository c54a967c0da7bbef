"""The repo's own user device code for `rtc.CudaKernel`, with the plain
PyTorch version of each kernel beside it, and the `rtc_softmax_ce`
custom op that pushes two of them.

CUDA sources (compiled by NVRTC at the first push, see rtc.py):

  csrc/rtc/elementwise.cu  double (x * 2), scale_shift (x * 4 - 1),
                           saxpy (2.5 * x + y): the bodies the JAX
                           package runs as Pallas kernels through
                           PallasKernel.push (tests/test_feedforward_rtc.py,
                           tests/test_capi_tier4.py,
                           cpp-package/example/recordio_rtc.cc); entry
                           points <name>_f32, <name>_bf16, <name>_i32 by
                           output type
  csrc/rtc/softmax_ce.cu   softmax_ce_forward (row softmax) and
                           softmax_ce_backward (softmax - onehot(label))

`kernel(fn_name)` is the process's CudaKernel of an entry point (built
once; the elementwise ones with `items_per_thread=ELEMENTWISE_ITEMS`, the
elements a thread moves in each pass of their grid-stride loop). The plain versions are what the CPU
tests hold the JAX package's bodies to and what chip_smoke.py holds the
kernels to on the card.

The head's geometry comes from the row length `cols` alone
(`softmax_geometry`, `softmax_backward_block`); each row takes one CTA.
A row of up to 4 * SOFTMAX_MAX_BLOCK floats takes the next power of two
of ceil(cols / 4) threads (at least a warp), one float4 a thread. A
longer row of a multiple of 4 floats: a thread holds up to
4 * SOFTMAX_VEC floats in registers, so it needs ceil(cols / 32)
threads, the next power of two of them; past SOFTMAX_MAX_BLOCK such
threads (32,768 floats), and for any longer row of another length (it
loads scalars), the row streams twice through a 1024-thread CTA (the
online path). Rows of a tensor whose start is not 16-byte aligned load
scalars whatever their length. A one-warp CTA reduces with
shuffles only. The backward takes one CTA a row, enough threads (256 to
1024) for one pass of BWD_UNROLL float4s each.

`rtc_softmax_ce` (registered when this module is imported) is a loss
head in place of SoftmaxOutput, as examples/numpy_ops/custom_softmax.py
writes one with numpy: forward softmax over each row of (N, ...) data
flattened to (N, -1), backward softmax - onehot(label), unscaled and
unnormalized, which is SoftmaxOutput's gradient with its defaults. On a
CUDA tensor it pushes the two kernels (one launch each); on a CPU
tensor it runs their plain versions.
"""
from __future__ import annotations

import os
import threading

import torch

from . import operator as _operator
from .ndarray import NDArray
from .rtc import CudaKernel

RTC_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "csrc", "rtc")
_FILE_OF = {f"{body}_{kind}": "elementwise"
            for body in ("double", "scale_shift", "saxpy")
            for kind in ("f32", "bf16", "i32")}
_FILE_OF.update(softmax_ce_forward="softmax_ce",
                softmax_ce_backward="softmax_ce")
EW_UNROLL = 4                 # quads a thread moves a pass (EW_UNROLL)
ELEMENTWISE_ITEMS = 4 * EW_UNROLL
SOFTMAX_VEC = 8               # float4s a forward thread holds (SOFTMAX_VEC)
SOFTMAX_MAX_BLOCK = 1024      # threads of a forward CTA, at most
BWD_UNROLL = 8                # float4s in flight a backward thread

_lock = threading.Lock()
_kernels = {}


def source_path(fn_name):
    """The repo path of the CUDA source that defines `fn_name`."""
    return os.path.join(RTC_SRC_DIR, f"{_FILE_OF[fn_name]}.cu")


def kernel(fn_name):
    """The CudaKernel of entry point `fn_name`, built once a process."""
    k = _kernels.get(fn_name)
    if k is not None:
        return k
    with _lock:
        k = _kernels.get(fn_name)
        if k is None:
            with open(source_path(fn_name)) as f:
                k = _kernels[fn_name] = CudaKernel(
                    fn_name, f.read(), fn_name,
                    items_per_thread=ELEMENTWISE_ITEMS
                    if _FILE_OF[fn_name] == "elementwise" else 1)
        return k


def _pow2_at_least(v):
    return 1 << max(0, int(v) - 1).bit_length()


def softmax_geometry(cols):
    """(block, path) of the forward over rows of `cols` floats; path is
    "registers" (each row read once) or "online" (twice)."""
    quads = -(-int(cols) // 4)
    if quads <= SOFTMAX_MAX_BLOCK:          # one float4 a thread
        return max(_pow2_at_least(quads), 32), "registers"
    threads = -(-int(cols) // (4 * SOFTMAX_VEC))
    if cols % 4 == 0 and threads <= SOFTMAX_MAX_BLOCK:
        return _pow2_at_least(threads), "registers"   # SOFTMAX_VEC float4s
    return SOFTMAX_MAX_BLOCK, "online"


def softmax_backward_block(cols):
    """Threads of the backward's CTA over rows of `cols` floats: enough
    for one pass of BWD_UNROLL float4s a thread, from 256 up to 1024."""
    return min(max(_pow2_at_least(-(-int(cols) // (4 * BWD_UNROLL))), 256),
               1024)


# ------------------------------------------------------- plain versions
def double_plain(x):
    return x * 2.0


def scale_shift_plain(x):
    return x * 4.0 - 1.0


def saxpy_plain(x, y):
    return 2.5 * x + y


def softmax_plain(x):
    """Row softmax of (rows, cols) float32, as the kernel computes it:
    exp(x - max) / sum."""
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    return e / e.sum(dim=1, keepdim=True)


def softmax_ce_backward_plain(prob, label):
    """prob - onehot(label) over (rows, cols); labels (rows,) float32
    truncated toward zero, out-of-range labels subtract nothing."""
    lab = label.to(torch.int64)
    ids = torch.arange(prob.shape[1], device=prob.device)
    return prob - (lab[:, None] == ids).to(prob.dtype)


# ----------------------------------------------------------- the head
def softmax_ce_forward(x):
    """prob of (rows, cols) contiguous float32 `x`."""
    if x.device.type == "cpu":
        return softmax_plain(x)
    rows, cols = x.shape
    block, _ = softmax_geometry(cols)
    prob = torch.empty_like(x)
    kernel("softmax_ce_forward").push_into([x], [prob], grid=rows,
                                           block=block)
    return prob


def softmax_ce_backward(prob, label):
    """grad of the data from `prob` (rows, cols) and `label` (rows,)."""
    if prob.device.type == "cpu":
        return softmax_ce_backward_plain(prob, label)
    grad = torch.empty_like(prob)
    kernel("softmax_ce_backward").push_into(
        [prob, label], [grad], grid=prob.shape[0],
        block=softmax_backward_block(prob.shape[1]))
    return grad


class SoftmaxCE(_operator.CustomOp):
    """Softmax cross-entropy head through the rtc kernels."""

    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0].data
        prob = softmax_ce_forward(
            x.reshape(x.shape[0], -1).to(torch.float32).contiguous())
        self.assign(out_data[0], req[0], NDArray(prob.reshape(x.shape)))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        prob = out_data[0].data
        label = in_data[1].data.to(torch.float32).contiguous()
        grad = softmax_ce_backward(
            prob.reshape(prob.shape[0], -1).contiguous(), label)
        self.assign(in_grad[0], req[0], NDArray(grad.reshape(prob.shape)))


@_operator.register("rtc_softmax_ce")
class SoftmaxCEProp(_operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return SoftmaxCE()
