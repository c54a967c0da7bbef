"""mxnet_tpu_torch.elastic — elastic, preemption-tolerant training
(mxnet_tpu/elastic/).

The control plane that lets a training job SHRINK, CONTINUE and
RE-GROW on any membership change — at bitwise parity with the run that
was never interrupted.

Composition of earlier tiers (nothing here reinvents substrate):

  fleet/wire.py        length-prefixed JSON framing, writer-thread
                       channels, heartbeat/staleness discipline
  sharding/plan.py     ShardingPlan expresses the before/after
                       {'fsdp': world} layouts; checkpoint_sharded's
                       per-param spec strings serialize them
  data/sampler.py      Philox ShardedSampler re-keys logical-shard
                       ownership mid-epoch (set_membership)
  numerics/runlog.py   the kill-surviving run event log persists every
                       transition's quiesce/resume record
  fault.py             FaultInjector 'kill:step:N' SIGKILLs a live
                       worker — the soak's preemption stand-in

The bit-identity invariant (docs/elastic.md): the job is cut into a
FIXED number of logical shards S. Global step p always consumes the
same S micro-batches, their gradients always combine in logical-shard
order, and the elementwise optimizer update decomposes over dim-0
slices — so which PHYSICAL worker computed what is arithmetically
invisible, and final params after any shrink/re-grow sequence are
`np.array_equal` to the uninterrupted run's. On the card that needs
each micro-batch's gradient to have the same bits in every worker
process: a worker on the card runs cuDNN's deterministic algorithms
with TF32 off and a fixed cuBLAS workspace
(`trainer.deterministic_card`).

Entry points: `ElasticCoordinator` (membership + step engine + the
three-step transition: quiesce → reshard → re-key), `run_worker` /
`python -m mxnet_tpu_torch.elastic.agent` (worker agent; `--ctx gpu`,
the default, or `cpu`), `JobSpec` + `elastic_job` entry-point
convention, `model.fit_elastic` sugar.
"""
from __future__ import annotations

from .trainer import ElasticSGD, JobSpec, load_entry
from .coordinator import ElasticCoordinator
from .agent import ElasticWorker, run_worker

__all__ = [
    "ElasticCoordinator",
    "ElasticSGD",
    "ElasticWorker",
    "JobSpec",
    "load_entry",
    "run_worker",
]
