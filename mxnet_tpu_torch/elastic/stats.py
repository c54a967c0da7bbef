"""Elastic-tier counters — the `elasticStats` view in profiler dumps,
/metrics and /statusz (mxnet_tpu/elastic/stats.py, over the port's
telemetry registry and views; the instruments keep the JAX package's
`mxnet_tpu_elastic_*` names).

The fleet tier counts request placement; the elastic tier counts
MEMBERSHIP — what the training world looked like, how often it
changed, and what each change cost:

  world / generation   current membership size and how many
                       transitions produced it
  transitions_shrink / transitions_grow
                       membership changes by direction (a preemption
                       is a shrink, a rejoin/scale-up a grow)
  quiesce_wall_ms_*    time the job spent parked at the quiesce
                       barrier (the availability cost of a change)
  reshard_bytes_moved  state actually transferred by the placement
                       delta, vs reshard_bytes_full_restore — what a
                       naive restore-everyone broadcast would have
                       shipped (the saving the delta design buys)
  examples_rekeyed     unconsumed examples whose ownership the
                       sampler re-key reassigned (each one is proof
                       of the no-drop/no-double-see contract at work)
  digest_mismatches    heartbeat param digests disagreeing across
                       workers — bitwise drift caught live, must stay 0
  workers              per-member rows (rank, last completed step,
                       exec-cache traces, staleness) from heartbeats

Registered as a separate omit_empty view so profiler dumps without an
elastic job stay byte-identical (serving/decoding/fleet snapshot
shapes are pinned by tests and untouched).
"""
from __future__ import annotations

import threading

from ..telemetry import register_view as _register_view
from ..telemetry import registry as _treg

_registry_lock = threading.Lock()
_registry: "dict[str, ElasticStats]" = {}

# native instruments (Prometheus-typed companions of the snapshot)
_MEMBERS = _treg.gauge(
    "mxnet_tpu_elastic_members",
    "Active worker members of the elastic training job")
_TRANSITIONS = _treg.counter(
    "mxnet_tpu_elastic_transitions_total",
    "Membership transitions driven to completion "
    "(direction=shrink|grow)")
_RESHARD_BYTES = _treg.counter(
    "mxnet_tpu_elastic_reshard_bytes_total",
    "State bytes moved by placement deltas across all transitions")
_QUIESCE_WALL = _treg.gauge(
    "mxnet_tpu_elastic_quiesce_wall_ms",
    "Wall time of the latest quiesce barrier in ms")
_REKEYED = _treg.counter(
    "mxnet_tpu_elastic_examples_rekeyed_total",
    "Unconsumed epoch examples whose shard ownership a transition "
    "re-keyed")


def _register(key, stats):
    with _registry_lock:
        _registry[key] = stats


def _unregister(key):
    with _registry_lock:
        _registry.pop(key, None)


def elastic_stats():
    """Snapshot of every live coordinator: {"job_name": {...}}."""
    with _registry_lock:
        items = list(_registry.items())
    return {key: st.snapshot() for key, st in items}


_register_view("elasticStats", elastic_stats, prom_prefix="elastic",
               omit_empty=True, label_name="job")


class ElasticStats:
    """Counters for one coordinator. `workers_fn` returns the live
    per-member rows (from the coordinator's member table) at snapshot
    time, so the snapshot is always the heartbeat-fresh view."""

    def __init__(self, key, workers_fn=None):
        self._key = key
        self._lock = threading.Lock()
        self._workers_fn = workers_fn
        self.world = 0
        self.generation = 0
        self.steps_completed = 0
        self.transitions_shrink = 0
        self.transitions_grow = 0
        self.quiesce_wall_ms_last = 0.0
        self.quiesce_wall_ms_total = 0.0
        self.reshard_bytes_moved = 0
        self.reshard_bytes_full_restore = 0
        self.examples_rekeyed = 0
        self.digest_mismatches = 0

    def note_membership(self, world, generation):
        with self._lock:
            self.world = int(world)
            self.generation = int(generation)
        _MEMBERS.set(int(world), job=self._key)

    def note_step(self, n=1):
        with self._lock:
            self.steps_completed += n

    def note_transition(self, direction, quiesce_wall_ms,
                        bytes_moved, bytes_full_restore,
                        examples_rekeyed):
        with self._lock:
            if direction == "shrink":
                self.transitions_shrink += 1
            else:
                self.transitions_grow += 1
            self.quiesce_wall_ms_last = float(quiesce_wall_ms)
            self.quiesce_wall_ms_total += float(quiesce_wall_ms)
            self.reshard_bytes_moved += int(bytes_moved)
            self.reshard_bytes_full_restore += int(bytes_full_restore)
            self.examples_rekeyed += int(examples_rekeyed)
        _TRANSITIONS.inc(1, direction=direction, job=self._key)
        _RESHARD_BYTES.inc(int(bytes_moved), job=self._key)
        _QUIESCE_WALL.set(float(quiesce_wall_ms), job=self._key)
        _REKEYED.inc(int(examples_rekeyed), job=self._key)

    def note_digest_mismatch(self, n=1):
        with self._lock:
            self.digest_mismatches += n

    def snapshot(self):
        with self._lock:
            out = {
                "world": self.world,
                "generation": self.generation,
                "steps_completed": self.steps_completed,
                "transitions": (self.transitions_shrink
                                + self.transitions_grow),
                "transitions_shrink": self.transitions_shrink,
                "transitions_grow": self.transitions_grow,
                "quiesce_wall_ms_last": self.quiesce_wall_ms_last,
                "quiesce_wall_ms_total": self.quiesce_wall_ms_total,
                "reshard_bytes_moved": self.reshard_bytes_moved,
                "reshard_bytes_full_restore":
                    self.reshard_bytes_full_restore,
                "examples_rekeyed": self.examples_rekeyed,
                "digest_mismatches": self.digest_mismatches,
            }
        fn = self._workers_fn
        out["workers"] = list(fn()) if fn is not None else []
        return out
