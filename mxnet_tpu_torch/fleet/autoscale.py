"""Queue-depth/p99-driven replica-count controller
(mxnet_tpu/fleet/autoscale.py).

Pure decision logic, deliberately free of processes/sockets/clocks so
it unit-tests in microseconds: the router feeds it one observation
per monitor tick (mean per-replica queue depth from heartbeats, live
replica count, optionally the fleet p99) and acts on the returned
delta (+1 spawn, -1 drain, 0 hold).

Flap resistance is two-layered, both required by the test suite:

  * a hysteresis BAND — grow at >= queue_high, shrink at <=
    queue_low; anything between holds and RESETS both streaks, so a
    load level oscillating inside the band never scales;
  * PATIENCE — the out-of-band reading must persist for `patience`
    consecutive observations before acting, so a single bursty tick
    (one big submit, one idle heartbeat) moves nothing.

After a decision both streaks reset: the next action needs fresh
consecutive evidence at the NEW replica count (spin-up is cheap —
bundle restore — but not free).
"""
from __future__ import annotations

from . import config as _cfg


class Autoscaler:
    """Grow/shrink decisions over [min_replicas, max_replicas]."""

    def __init__(self, min_replicas=1, max_replicas=8, queue_high=None,
                 queue_low=None, patience=3, p99_high_ms=None):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = (queue_high if queue_high is not None
                           else _cfg.queue_high())
        self.queue_low = (queue_low if queue_low is not None
                          else _cfg.queue_low())
        if self.queue_low >= self.queue_high:
            raise ValueError(
                f"queue_low ({self.queue_low}) must sit below "
                f"queue_high ({self.queue_high}): the gap is the "
                "hysteresis band")
        self.patience = max(1, int(patience))
        # optional latency trigger: p99 above this grows even when
        # queue depth looks fine (deep decodes, shallow queues)
        self.p99_high_ms = p99_high_ms
        self._above = 0
        self._below = 0

    def observe(self, mean_depth, n_replicas, p99_ms=None):
        """One monitor tick -> -1 | 0 | +1 replica delta."""
        hot = mean_depth >= self.queue_high or (
            self.p99_high_ms is not None and p99_ms is not None
            and p99_ms >= self.p99_high_ms)
        cold = not hot and mean_depth <= self.queue_low
        if hot:
            self._above += 1
            self._below = 0
        elif cold:
            self._below += 1
            self._above = 0
        else:
            # inside the band: both streaks die (flap resistance)
            self._above = 0
            self._below = 0
            return 0
        if self._above >= self.patience and n_replicas < self.max_replicas:
            self._above = 0
            self._below = 0
            return 1
        if self._below >= self.patience and n_replicas > self.min_replicas:
            self._above = 0
            self._below = 0
            return -1
        return 0
