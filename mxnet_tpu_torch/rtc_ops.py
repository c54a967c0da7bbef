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
once). The plain versions are what the CPU tests hold the JAX package's
bodies to and what chip_smoke.py holds the kernels to on the card.

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
SOFTMAX_BLOCK = 256

_lock = threading.Lock()
_kernels = {}


def source_path(fn_name):
    """The repo path of the CUDA source that defines `fn_name`."""
    return os.path.join(RTC_SRC_DIR, f"{_FILE_OF[fn_name]}.cu")


def kernel(fn_name):
    """The CudaKernel of entry point `fn_name`, built once a process."""
    with _lock:
        k = _kernels.get(fn_name)
        if k is None:
            with open(source_path(fn_name)) as f:
                k = _kernels[fn_name] = CudaKernel(fn_name, f.read(),
                                                   fn_name)
        return k


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
    (prob,) = kernel("softmax_ce_forward").push(
        [x], [x.shape], grid=x.shape[0], block=SOFTMAX_BLOCK)
    return prob.data


def softmax_ce_backward(prob, label):
    """grad of the data from `prob` (rows, cols) and `label` (rows,)."""
    if prob.device.type == "cpu":
        return softmax_ce_backward_plain(prob, label)
    (grad,) = kernel("softmax_ce_backward").push(
        [prob, label], [prob.shape], grid=prob.shape[0],
        block=SOFTMAX_BLOCK)
    return grad.data


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
