"""The deterministic toy job the elastic CI gate and tests train
(mxnet_tpu/elastic/ci_job.py: the same DEFAULTS, data and initial
parameters, bit for bit).

A 2-layer MLP on synthetic data, fully determined by the config dict —
every process (coordinator, each worker, the uninterrupted reference
run) that resolves `mxnet_tpu_torch.elastic.ci_job:build` with the same
config materializes byte-identical training data and the same symbol,
so the only state that ever crosses the wire is params/gradients/
momentum, and final-param comparisons are meaningful to the bit.

Sized so a full run is seconds on CPU yet still crosses epoch
boundaries mid-job: the bit-identity claim has to survive an epoch
re-key, not just a single permutation.
"""
from __future__ import annotations

import numpy as np

from .trainer import JobSpec

DEFAULTS = {
    "features": 12,
    "hidden": 16,
    "classes": 4,
    "num_samples": 256,
    "batch_size": 8,
    "logical_shards": 2,
    "epochs": 2,
    "seed": 7,
    "data_seed": 1234,
    "lr": 0.05,
    "momentum": 0.9,
}


def build(config=None):
    """Job factory (the `entry` convention: config dict -> JobSpec)."""
    import mxnet_tpu_torch as mx

    c = dict(DEFAULTS)
    c.update(config or {})
    rng = np.random.RandomState(int(c["data_seed"]))
    x = rng.rand(int(c["num_samples"]),
                 int(c["features"])).astype(np.float32)
    y = rng.randint(0, int(c["classes"]),
                    size=(int(c["num_samples"]),)).astype(np.float32)

    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(d, num_hidden=int(c["hidden"]),
                              name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=int(c["classes"]),
                              name="fc2")
    net = mx.sym.SoftmaxOutput(h, name="softmax")

    return JobSpec(
        net, x, y,
        batch_size=c["batch_size"],
        logical_shards=c["logical_shards"],
        epochs=c["epochs"],
        seed=c["seed"],
        lr=c["lr"],
        momentum=c["momentum"],
    )
