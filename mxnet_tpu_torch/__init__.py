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
  the public surface imperative `nd` ops and `autograd` (mark_variables,
                     train_section, compute_gradient), the Module
                     lifecycle (predict, checkpoints, optimizer
                     states, reshape), the optimizer, initializer,
                     metric, scheduler, callback and iterator families
  the Module family  BucketingModule, SequentialModule, PythonModule and
                     `Module.cast_compute` (bf16 compute, float32 master
                     weights); the `rnn` cells, BucketSentenceIter and
                     the RNN checkpoints
  data parallelism   `kv` (KVStore 'local', 'device', 'dist_sync',
                     'dist_async', 'tpu') over torch.distributed's gloo
                     group of tools/launch.py's workers, Module over
                     several contexts, `parallel.mesh` and the fused
                     step's data mesh in one process and across processes
  model parallelism  `sharding` (`ShardingPlan`), the model, seq, fsdp and
                     tp mesh axes in Module and the fused step (shards
                     kept a process across tools/launch.py's workers),
                     ring and Ulysses attention, `save_sharded` /
                     `load_sharded`, and `analysis.verify_sharding`
  fused training     `Module`'s fused train step (`parallel/dp_step.py`:
                     forward, backward and the optimizer update as one
                     CUDA graph replayed each step), `run_steps` and
                     `fit(steps_per_dispatch=)`, the dispatch-ahead
                     window; run health (`numerics`, `NumericsMonitor`),
                     `Monitor` and device-side `profiling`
  input pipeline     `recordio` (RecordIO files, the JAX package's bytes),
                     `data` (sharded, resumable DataLoader and
                     DevicePrefetchIter, which stages batches on the card
                     through a pinned ring on a side stream), `image` and
                     `image_det` (augmenters, ImageIter, ImageDetIter)
  compile tier       the bucketed optimizer update, fused bucketing, the
                     opt-in `layout` pass, `passes.cost_model` and the
                     `passes.Autotuner`
  fleet              `fleet.FleetRouter` over replica processes that each
                     restore one serving bundle on the card
                     (`python -m mxnet_tpu_torch.fleet.replica`), prefix-
                     affinity routing, heal after a SIGKILL, drain and
                     hand-off, and the admin CLI
                     (`python -m mxnet_tpu_torch.fleet.cli`)
  elastic            `elastic.ElasticCoordinator` and worker processes
                     (`python -m mxnet_tpu_torch.elastic.agent`,
                     `model.fit_elastic`) that train through a shrink and
                     a re-grow to the uninterrupted run's parameters, bit
                     for bit, on the card
  one-shot serving   `serving.ModelServer` (dynamic batching over a
                     grid of `Predictor` cells warmed at load, decoders
                     beside them), the `exec_cache` of bind plans, the
                     `telemetry` registry, exporter and flight recorder,
                     and `profiler` (Chrome traces with a torch.profiler
                     capture)
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
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import ops  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import name  # noqa: F401
from . import attribute  # noqa: F401
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
from . import rnn  # noqa: F401
from . import parallel  # noqa: F401
from . import operator  # noqa: F401
from . import rtc  # noqa: F401
from . import model  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import executor_manager  # noqa: F401
from . import feed_forward  # noqa: F401
from . import test_utils  # noqa: F401
from . import exec_cache  # noqa: F401
from . import profiler  # noqa: F401
from . import predictor  # noqa: F401
from . import monitor as _monitor_mod  # noqa: F401
from .monitor import Monitor
from . import numerics  # noqa: F401
from .numerics import NumericsMonitor
from . import profiling  # noqa: F401
from . import recordio  # noqa: F401
from . import data  # noqa: F401
from . import image  # noqa: F401
from . import image_det  # noqa: F401
from . import sharding  # noqa: F401
from .sharding import ShardingPlan
from . import checkpoint_sharded  # noqa: F401
from .checkpoint_sharded import load_sharded, save_sharded
from . import analysis  # noqa: F401
from . import fault  # noqa: F401
from . import fleet  # noqa: F401
from . import elastic  # noqa: F401
from . import visualization  # noqa: F401
from . import visualization as viz  # noqa: F401
from .base import MXNetError
from .callback import Speedometer
from .context import (Context, cpu, cpu_pinned, current_context,
                      default_context, gpu, memory_stats, num_devices,
                      set_memory_fraction)
from .executor import Executor
from .feed_forward import FeedForward
from .ndarray import NDArray
from .predictor import Predictor
from .symbol import AttrScope, Group, Variable

__version__ = "0.1.0"

__all__ = ["AttrScope", "Context", "Executor", "FeedForward", "Group",
           "MXNetError", "Monitor", "NDArray", "NumericsMonitor",
           "Predictor", "ShardingPlan", "Speedometer", "Variable",
           "__version__", "analysis", "attribute", "autograd", "base",
           "callback", "checkpoint_sharded",
           "context", "cpu",
           "cpu_pinned", "current_context", "data", "decoding",
           "default_context", "elastic",
           "exec_cache",
           "executor",
           "executor_manager", "fault", "feed_forward", "fleet", "gpu",
           "image", "image_det", "init", "initializer", "io", "kv",
           "kvstore",
           "lr_scheduler", "memory_stats", "metric", "mod", "model",
           "models", "module", "monitor", "name", "nd", "ndarray",
           "num_devices",
           "numerics", "operator", "ops", "optimizer", "parallel",
           "passes", "predictor", "profiler", "profiling", "random",
           "load_sharded", "recordio", "rnn", "rtc", "save_sharded",
           "serving", "set_memory_fraction", "sharding",
           "sym", "symbol", "telemetry", "utils", "visualization",
           "viz"]
