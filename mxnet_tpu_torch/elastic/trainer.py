"""Membership-invariant training arithmetic (mxnet_tpu/elastic/
trainer.py: `JobSpec`, `load_entry`, `ElasticSGD` and `combine_grads`
are the same numpy code, bit for bit; `ModuleStepper` binds on the
worker's context).

The elastic acceptance bar is bitwise: final params after any
shrink/re-grow sequence must `np.array_equal` the uninterrupted run.
Floating-point addition does not commute, so bit-identity is only
reachable if the ARITHMETIC of a global step is pinned down
independently of the physical membership. Three pins do it:

1. **Fixed logical shards.** The job is cut into S logical gradient
   shards for its whole lifetime (`JobSpec.logical_shards`). Global
   step p consumes logical shard s's batch p for every s — the same S
   micro-batches whoever computes them. Workers own shards round-robin
   (`s % world == rank`, the sampler's `set_membership` convention)
   and a worker owning several just runs several micro-batches.

2. **Shard-ordered combine.** Micro-batch gradients are summed in
   logical-shard order 0..S-1 and scaled by float32(1/S) — one fixed
   reduction tree, evaluated identically for any world size
   (`combine_grads`). Each micro-batch gradient itself comes from one
   compiled program at one fixed shape, so it is bitwise reproducible
   wherever it runs (`ModuleStepper`).

3. **Slice-decomposable updates.** `ElasticSGD` is elementwise
   (momentum SGD in float32 numpy), so applying it to a dim-0 slice
   of (param, grad, state) equals slicing the full-tensor update:
   owner-sharded updates under ANY placement produce the same bits as
   one giant update. That is what makes optimizer-state resharding a
   pure data-movement problem (reshard.py) with no numeric seam.
"""
from __future__ import annotations

import importlib
import os

import numpy as np

from ..base import MXNetError


def load_entry(entry):
    """Resolve 'pkg.mod:fn' to the callable job factory. Every process
    of a job (coordinator and each worker) resolves the same entry and
    builds the same JobSpec from the same config — the job definition
    travels as a name, never as pickled code."""
    mod, _, fn = str(entry).partition(":")
    if not mod or not fn:
        raise MXNetError(
            f"bad elastic entry {entry!r}: expected 'pkg.mod:fn'")
    target = getattr(importlib.import_module(mod), fn, None)
    if not callable(target):
        raise MXNetError(
            f"elastic entry {entry!r} does not name a callable")
    return target


class JobSpec(object):
    """One elastic training job, fully materialized: the symbol, the
    (host-resident) training arrays, the step grid, and the optimizer
    hyperparameters. Built by an entry function from a JSON-safe
    config dict, identically in every process."""

    def __init__(self, symbol, data, label, batch_size,
                 logical_shards, epochs, seed=0, lr=0.1, momentum=0.9,
                 label_name="softmax_label"):
        self.symbol = symbol
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.label = np.ascontiguousarray(label, dtype=np.float32)
        if len(self.data) != len(self.label):
            raise MXNetError(
                f"data/label length mismatch: {len(self.data)} vs "
                f"{len(self.label)}")
        self.batch_size = int(batch_size)
        self.logical_shards = int(logical_shards)
        self.epochs = int(epochs)
        self.seed = int(seed)
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.label_name = str(label_name)
        self.num_samples = len(self.data)
        shard_len = self.num_samples // self.logical_shards
        self.batches_per_epoch = shard_len // self.batch_size
        if self.batches_per_epoch < 1:
            raise MXNetError(
                f"{self.num_samples} samples over "
                f"{self.logical_shards} shards yield no full batch "
                f"of {self.batch_size}")
        self.total_steps = self.epochs * self.batches_per_epoch

    def param_shapes(self):
        """{param: shape} by symbol shape inference — no module bind,
        no compile (the coordinator never steps the model, it only
        needs the state template)."""
        feat = tuple(self.data.shape[1:])
        arg_shapes, _, _ = self.symbol.infer_shape(
            **{"data": (self.batch_size,) + feat,
               self.label_name: (self.batch_size,)})
        names = self.symbol.list_arguments()
        return {n: tuple(s) for n, s in zip(names, arg_shapes)
                if n not in ("data", self.label_name)}

    def initial_params(self, shapes):
        """Seeded initial params ({name: float32 np}) — a pure
        function of (seed, sorted names, shapes), so the reference
        leg and the fault leg of the CI gate start from identical
        bits even in different processes (Module.init_params gives no
        such cross-process guarantee)."""
        rng = np.random.RandomState((self.seed ^ 0x5EED) & 0x7FFFFFFF)
        return {n: rng.uniform(-0.05, 0.05,
                               size=tuple(shapes[n])).astype(np.float32)
                for n in sorted(shapes)}

    def make_sampler(self):
        """The job's logical-shard sampler (membership applied by the
        caller via set_membership)."""
        from ..data.sampler import ShardedSampler

        return ShardedSampler(
            self.num_samples, self.batch_size, seed=self.seed,
            shard_id=0, num_shards=self.logical_shards, shuffle=True)

    def batch_arrays(self, indices):
        """(x, y) micro-batch for one index batch."""
        return self.data[indices], self.label[indices]


class ElasticSGD(object):
    """Momentum SGD, elementwise in float32 numpy.

    `update(p, g, m)` mutates all three in place:
        m <- momentum * m + g ;  p <- p - lr * m
    Every operand is a float32 scalar broadcast (no float64 promotion
    sneaks in) and every op is elementwise, so for any dim-0 split
    update(p, g, m) == concat(update(p_i, g_i, m_i)) bit for bit —
    the property the owner-sharded step and reshard both lean on."""

    def __init__(self, lr=0.1, momentum=0.9):
        self.lr = np.float32(lr)
        self.momentum = np.float32(momentum)

    def init_state(self, shapes):
        return {n: np.zeros(tuple(s), dtype=np.float32)
                for n, s in shapes.items()}

    def update(self, param, grad, mom):
        np.multiply(mom, self.momentum, out=mom)
        np.add(mom, grad, out=mom)
        param -= self.lr * mom
        return param, mom


def combine_grads(shard_grads, logical_shards):
    """Mean of per-shard gradients in logical-shard order — THE fixed
    reduction: sum s=0..S-1 then scale by float32(1/S). `shard_grads`
    maps shard id -> {param: grad}; all S must be present."""
    S = int(logical_shards)
    missing = [s for s in range(S) if s not in shard_grads]
    if missing:
        raise MXNetError(f"combine missing shards {missing}")
    inv = np.float32(1.0 / S)
    out = {}
    for name in sorted(shard_grads[0]):
        acc = shard_grads[0][name].astype(np.float32, copy=True)
        for s in range(1, S):
            acc += shard_grads[s][name]
        acc *= inv
        out[name] = acc
    return out


def deterministic_card():
    """Pin what decides a gradient's bits on the card, in this process:
    cuDNN's deterministic algorithms by its heuristics (no benchmark
    search, which may pick another algorithm in another process), no
    TF32 in convolutions or matrix products, and a fixed cuBLAS
    workspace (CUBLAS_WORKSPACE_CONFIG, read when the process creates
    its first cuBLAS handle, so it must be set before any matrix product
    runs there). A micro-batch's gradient then has the same bits in
    whichever worker process computes it."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class ModuleStepper(object):
    """One bound eager Module = one bind plan at one fixed micro-batch
    shape, on `ctx` (the current context when None: the card unless the
    CPU is named). `grads(x, y)` runs it and returns host float32
    gradients; `install(params)` makes the next step compute against an
    exact external param state.

    Deliberately eager (no `init_optimizer`, so no fused step): the
    update must be the shared numpy `ElasticSGD` — running it inside a
    per-worker step would re-introduce membership-shaped arithmetic.
    On the card the process is pinned to deterministic algorithms
    before the bind (`deterministic_card`). One warmup forward/backward
    at construction builds the plan and initializes cuDNN and cuBLAS;
    no later step traces again.

    As in the JAX package, the label binds as (batch_size,) and
    `install` sets no auxiliary states with allow_missing=False, so a
    model with auxiliary states (BatchNorm) is refused at the first
    install."""

    def __init__(self, spec, ctx=None):
        import mxnet_tpu_torch as mx
        from ..context import current_context
        from ..io import DataDesc

        self._spec = spec
        self._nd = mx.nd
        self._DataBatch = mx.io.DataBatch
        self._ctx = ctx if ctx is not None else current_context()
        if self._ctx.torch_device().type == "cuda":
            deterministic_card()
        self._mod = mx.mod.Module(
            spec.symbol, label_names=(spec.label_name,),
            context=[self._ctx])
        feat = tuple(spec.data.shape[1:])
        self._mod.bind(
            [DataDesc("data", (spec.batch_size,) + feat)],
            [DataDesc(spec.label_name, (spec.batch_size,))],
            for_training=True)
        self._mod.init_params()
        self._eg = self._mod._exec_group
        self.grads(np.zeros((spec.batch_size,) + feat, np.float32),
                   np.zeros((spec.batch_size,), np.float32))

    @property
    def param_names(self):
        return list(self._eg.param_names)

    def params(self):
        """{name: float32 np} current params (a copy)."""
        arg, _ = self._mod.get_params()
        return {n: arg[n].asnumpy().astype(np.float32, copy=False)
                for n in self.param_names}

    def param_shapes(self):
        return {n: tuple(v.shape) for n, v in self.params().items()}

    def device_params(self):
        """{name: torch.Tensor} the executor computes with (on its
        context), for checks of where the parameters live."""
        ex = self._eg.execs[0]
        return {n: ex.arg_dict[n].data for n in self.param_names}

    def install(self, params):
        """Overwrite module params from {name: np}."""
        self._mod.set_params(
            {n: self._nd.array(v, ctx=self._ctx)
             for n, v in params.items()},
            {}, allow_missing=False)

    def grads(self, x, y):
        """Forward/backward one micro-batch; returns {name: float32
        np gradient} (copied out before the next launch reuses the
        grad buffers — grad_req is 'write')."""
        batch = self._DataBatch(
            data=[self._nd.array(x, ctx=self._ctx)],
            label=[self._nd.array(y, ctx=self._ctx)],
            pad=0, index=None)
        self._mod.forward(batch, is_train=True)
        self._mod.backward()
        return {
            n: self._eg.grad_arrays[i][0].asnumpy().astype(
                np.float32, copy=True)
            for i, n in enumerate(self._eg.param_names)
        }
