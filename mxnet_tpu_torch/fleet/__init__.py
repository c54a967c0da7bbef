"""mxnet_tpu_torch.fleet — the multi-replica serving control plane
(mxnet_tpu/fleet/: the same names, knobs, wire frames and stats view).

One process serves; a fleet SCALES. This package turns the
single-process serving/decoding stack into N replica worker
processes behind a router:

  router     FleetRouter — spawns replicas from one shared serving
             bundle (no bind plan built and no nvcc run per replica),
             routes predict/generate/stream over a length-prefixed
             JSON control plane, and is the order of record for every
             in-flight request
  affinity   AffinityIndex — prefix-affinity routing: prompts hash
             to page-chain digests (decoding.prefix.page_digests)
             and land on the replica whose advertised radix cache
             covers the longest prefix, so the per-process prefix
             cache becomes a fleet-wide asset
  replica    ReplicaWorker + the `python -m mxnet_tpu_torch.fleet.replica`
             entry point: bundle restore on `--ctx` (the card unless
             `cpu` is named), request handler threads, heartbeats
             (depth + stats + cache digests)
  autoscale  Autoscaler — queue-depth/p99 thresholds with a
             hysteresis band and patience (no flapping)
  drain      DrainLedger + handoff validation — shrink and shutdown
             go through drain: stop admitting, finish or hand off
             live decodes, seal, exit. A SIGKILL mid-stream or a
             blown drain deadline lands in the same re-admission
             path (the router rebuilds from its own token record),
             so both are zero-loss and — under counter-based
             sampling — token for token the uninterrupted stream
  stats      FleetStats -> the `fleetStats` view (routing decisions,
             handoffs, deaths, autoscale churn, per-replica rows) +
             Prometheus gauges
  wire       the framing + Channel discipline (writer-thread outbox,
             single reader, nothing blocking under a lock)
  config     MXNET_FLEET_* env knob resolution
  cli        the admin CLI (`python -m mxnet_tpu_torch.fleet.cli`
             start/status/scale/drain/stop)

    from mxnet_tpu_torch import fleet
    router = fleet.FleetRouter("./bundle", replicas=3).start()
    toks = router.generate(prompt, max_new_tokens=64)
    for tok in router.stream(prompt): ...
    router.scale(5); router.drain_replica("r0"); router.stop()
"""
from . import affinity, autoscale, config, drain, replica, router, \
    stats, wire
from .affinity import AffinityIndex
from .autoscale import Autoscaler
from .drain import DrainLedger, check_handoff_state
from .replica import ReplicaWorker
from .router import FleetFuture, FleetRouter, ReplicaHandle
from .stats import FleetStats, fleet_stats
from .wire import Channel, MAX_FRAME, WireError, recv_frame, \
    send_frame

__all__ = [
    "AffinityIndex", "Autoscaler", "Channel", "DrainLedger",
    "FleetFuture", "FleetRouter", "FleetStats", "MAX_FRAME",
    "ReplicaHandle", "ReplicaWorker", "WireError", "affinity",
    "autoscale", "check_handoff_state", "config", "drain",
    "fleet_stats", "recv_frame", "replica", "router", "send_frame",
    "stats", "wire",
]
