"""Fleet-tier counters — the `fleetStats` view in profiler dumps,
/metrics and /statusz (mxnet_tpu/fleet/stats.py, over the port's
telemetry registry and views; the instruments keep the JAX package's
`mxnet_tpu_fleet_*` names).

The serving tier counts requests and the decode tier counts tokens
and pages; the fleet tier counts PLACEMENT — where requests landed
and why, and what each replica looked like when they did:

  routed_affinity / _least_loaded / _random
                       routing-decision mix; a healthy shared-prefix
                       workload routes mostly by affinity
  affinity_pages_covered
                       prompt pages the chosen replica had already
                       cached at routing time (each one is page_size
                       tokens of prefill it will skip)
  handoffs / readmissions
                       requests moved between replicas by drain (with
                       state) or death (rebuilt from the router's own
                       token record) — nonzero under churn is healthy,
                       a failed request is not
  replica_deaths / drains_* / autoscale_up / autoscale_down
                       control-plane churn accounting
  replicas             per-replica rows (depth, prefix hit rate, kv
                       occupancy, advertised prefixes, draining) from
                       the latest heartbeat

Registered as a separate omit_empty view so profiler dumps without a
fleet stay byte-identical (the serving/decoding snapshot shapes are
pinned by tests and untouched).
"""
from __future__ import annotations

import threading

from ..telemetry import register_view as _register_view
from ..telemetry import registry as _treg

_registry_lock = threading.Lock()
_registry: "dict[str, FleetStats]" = {}

# native instruments (Prometheus-typed companions of the snapshot)
_REPLICAS = _treg.gauge(
    "mxnet_tpu_fleet_replicas",
    "Live replica worker processes behind the router")
_QUEUE_DEPTH = _treg.gauge(
    "mxnet_tpu_fleet_mean_queue_depth",
    "Mean per-replica decode queue depth (heartbeat view)")
_ROUTED = _treg.counter(
    "mxnet_tpu_fleet_routed_total",
    "Requests routed (policy=affinity|least_loaded|random)")
_HANDOFFS = _treg.counter(
    "mxnet_tpu_fleet_handoffs_total",
    "Requests handed off by a draining replica and re-admitted")
_READMISSIONS = _treg.counter(
    "mxnet_tpu_fleet_readmissions_total",
    "Requests rebuilt from the router's token record after a "
    "replica died mid-decode")
_DEATHS = _treg.counter(
    "mxnet_tpu_fleet_replica_deaths_total",
    "Replica processes lost (crash, kill, or missed heartbeats)")
_AUTOSCALE = _treg.counter(
    "mxnet_tpu_fleet_autoscale_total",
    "Autoscaler decisions acted on (direction=up|down)")


def _register(key, stats):
    with _registry_lock:
        _registry[key] = stats


def _unregister(key):
    with _registry_lock:
        _registry.pop(key, None)


def fleet_stats():
    """Snapshot of every live router: {"router_name": {...}}."""
    with _registry_lock:
        items = list(_registry.items())
    return {key: st.snapshot() for key, st in items}


_register_view("fleetStats", fleet_stats, prom_prefix="fleet",
               omit_empty=True, label_name="router")


class FleetStats:
    """Counters for one router. `replicas_fn` returns the live
    per-replica rows (from the router's handle table) at snapshot
    time, so the snapshot is always the heartbeat-fresh view."""

    def __init__(self, key, replicas_fn=None):
        self._key = key
        self._lock = threading.Lock()
        self._replicas_fn = replicas_fn
        self.requests = 0
        self.routed_affinity = 0
        self.routed_least_loaded = 0
        self.routed_random = 0
        self.affinity_pages_covered = 0
        self.handoffs = 0
        self.readmissions = 0
        self.replica_deaths = 0
        self.autoscale_up = 0
        self.autoscale_down = 0
        self.failures = 0

    def note_routed(self, policy, pages_covered=0):
        with self._lock:
            self.requests += 1
            if policy == "affinity":
                self.routed_affinity += 1
                self.affinity_pages_covered += pages_covered
            elif policy == "random":
                self.routed_random += 1
            else:
                self.routed_least_loaded += 1
        _ROUTED.inc(1, policy=policy, router=self._key)

    def note_handoff(self, n=1):
        with self._lock:
            self.handoffs += n
        _HANDOFFS.inc(n, router=self._key)

    def note_readmission(self, n=1):
        with self._lock:
            self.readmissions += n
        _READMISSIONS.inc(n, router=self._key)

    def note_replica_death(self):
        with self._lock:
            self.replica_deaths += 1
        _DEATHS.inc(1, router=self._key)

    def note_autoscale(self, delta):
        with self._lock:
            if delta > 0:
                self.autoscale_up += 1
            else:
                self.autoscale_down += 1
        _AUTOSCALE.inc(1, direction="up" if delta > 0 else "down",
                       router=self._key)

    def note_failure(self, n=1):
        with self._lock:
            self.failures += n

    def note_fleet_gauges(self, n_replicas, mean_depth):
        """Monitor-tick refresh of the fleet-shape gauges."""
        _REPLICAS.set(n_replicas, router=self._key)
        _QUEUE_DEPTH.set(round(mean_depth, 3), router=self._key)

    def snapshot(self):
        replicas = self._replicas_fn() if self._replicas_fn else {}
        with self._lock:
            return {
                "requests": self.requests,
                "routed_affinity": self.routed_affinity,
                "routed_least_loaded": self.routed_least_loaded,
                "routed_random": self.routed_random,
                "affinity_pages_covered": self.affinity_pages_covered,
                "handoffs": self.handoffs,
                "readmissions": self.readmissions,
                "replica_deaths": self.replica_deaths,
                "autoscale_up": self.autoscale_up,
                "autoscale_down": self.autoscale_down,
                "failures": self.failures,
                "replicas": replicas,
            }
