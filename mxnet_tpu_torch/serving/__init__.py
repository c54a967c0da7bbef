"""Serving tier: the dynamic-batching inference server, the counterpart
of mxnet_tpu/serving/.

Turns the one-request-at-a-time `Predictor` into a throughput surface:
requests are bucketed into a small grid of padded (batch, length)
shapes, so the whole service runs on a handful of bind plans warmed at
load (no plan is built in steady state), with bounded-queue
backpressure, per-request deadlines and multi-model/version routing.
Decoders (`decoding.DecodedModel`) load into the same server.

    from mxnet_tpu_torch import serving
    server = serving.ModelServer()
    server.load("clf", symbol_json, params,
                input_specs={"data": ("L",)},
                input_dtypes={"data": "int32"},
                length_buckets=(16, 32, 64))     # warmup binds all
    out = server.predict("clf", {"data": token_ids})   # sync
    fut = server.submit("clf", {"data": token_ids})    # async Future

Modules: batcher (queue, bucketing, flush policy), server (ModelServer),
registry (multi-model, warmup), stats (qps/latency/fill/padding
counters, the `servingStats` view), config (MXNET_SERVING_* knobs),
bundle (`save_bundle` / `load_bundle`: one directory holding a warm
model's weights, optionally int8 (quant), and its plans and kernel
libraries).
"""
from . import batcher, bundle, config, registry, server, stats
from .batcher import (BucketSpec, DeadlineExceededError, DynamicBatcher,
                      ServerBusyError, ServerClosedError, ServingError,
                      default_batch_buckets, pick_bucket)
from .bundle import BundleError, load_bundle, read_manifest, save_bundle
from .registry import ModelRegistry, ServedModel
from .server import ModelServer
from .stats import ServingStats, reset_serving_stats, serving_stats

__all__ = [
    "BucketSpec", "BundleError", "DynamicBatcher",
    "DeadlineExceededError", "ModelRegistry", "ModelServer",
    "ServedModel", "ServerBusyError", "ServerClosedError",
    "ServingError", "ServingStats", "batcher", "bundle", "config",
    "default_batch_buckets", "load_bundle", "pick_bucket",
    "read_manifest", "registry", "reset_serving_stats", "save_bundle",
    "server", "serving_stats", "stats",
]
