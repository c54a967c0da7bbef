"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for one NVIDIA
H100.

The package imports torch and numpy only; it never imports jax or
mxnet_tpu. Its slices so far:

  decode serving     `decoding.DecodedModel`, whose paged attention is a
                     hand-written CUDA kernel (`csrc/paged_attention.cu`)
  symbolic training  Symbol -> graph passes -> Executor -> Module.fit
                     (`symbol`, `passes`, `executor`, `module`), whose
                     fusion groups run as generated CUDA kernels
                     (`passes/codegen.py`, `csrc/fusion_codegen.cuh`)
  long context       `parallel.attention(..., impl="flash")`, whose
                     forward is a hand-written CUDA kernel
                     (`csrc/flash_attention.cu`); the transformer tower
                     (`models.get_transformer`) trained through Module
                     with Adam
  user device code   `rtc.CudaKernel` (CUDA source compiled with NVRTC
                     and launched on NDArrays) inside custom ops
                     (`operator`, `sym.Custom`), trained and
                     checkpointed through `FeedForward` (`model`,
                     `executor_manager`); `rtc_ops` holds the repo's own
                     device code (`csrc/rtc/`) and the `rtc_softmax_ce`
                     head

Kernels are built with nvcc at first use. Entry points run on the CUDA
device unless the caller names another one (`mx.cpu()`, device="cpu").

    import mxnet_tpu_torch as mx
    net = mx.models.get_inception_resnet_v2()
    mod = mx.mod.Module(net)          # the card
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=32), num_epoch=1)
"""
from . import base, context, decoding, serving, telemetry, utils
from . import random  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import ops  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import passes  # noqa: F401
from . import executor  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import optimizer  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import metric  # noqa: F401
from . import io  # noqa: F401
from . import callback  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import models  # noqa: F401
from . import parallel  # noqa: F401
from . import operator  # noqa: F401
from . import rtc  # noqa: F401
from . import model  # noqa: F401
from . import executor_manager  # noqa: F401
from . import feed_forward  # noqa: F401
from .base import MXNetError
from .callback import Speedometer
from .context import Context, cpu, current_context, default_context, gpu
from .executor import Executor
from .feed_forward import FeedForward
from .ndarray import NDArray
from .symbol import AttrScope, Group, Variable

__version__ = "0.1.0"

__all__ = ["AttrScope", "Context", "Executor", "FeedForward", "Group",
           "MXNetError", "NDArray", "Speedometer", "Variable",
           "__version__", "base", "callback", "context", "cpu",
           "current_context", "decoding", "default_context", "executor",
           "executor_manager", "feed_forward", "gpu", "init",
           "initializer", "io", "lr_scheduler", "metric", "mod", "model",
           "models", "module", "nd", "ndarray", "operator", "ops",
           "optimizer", "parallel", "passes", "random", "rtc", "serving",
           "sym", "symbol", "telemetry", "utils"]
