"""Drain bookkeeping + handoff-record validation for the router
(mxnet_tpu/fleet/drain.py).

A drain is a CONTRACT with a deadline: the replica stops admitting,
runs live decodes to completion, hands off the rest, then exits. The
`DrainLedger` tracks every drain in flight so the monitor tick can
escalate one that blew its deadline (kill the process — the router
re-admits its requests from its own token record, so escalation is
still zero-loss, just later).

`check_handoff_state` is the router's trust boundary on records
arriving over the wire: a malformed record raises here, at ingest,
instead of surfacing as a confusing admission error on the replica
it gets re-routed to.

Clocks are injected (`now` parameters, monotonic seconds) — no wall
time, no internal clock reads — so the ledger unit-tests without
sleeping.
"""
from __future__ import annotations

import threading

from ..serving.batcher import ServingError


def check_handoff_state(state):
    """Validate one handoff/resume record; returns it (with token
    lists coerced to ints) or raises ServingError."""
    if not isinstance(state, dict):
        raise ServingError(f"handoff state must be a dict, "
                           f"got {type(state).__name__}")
    for field in ("prompt", "max_new_tokens"):
        if field not in state:
            raise ServingError(f"handoff state missing {field!r}")
    try:
        state["prompt"] = [int(t) for t in state["prompt"]]
        state["generated"] = [int(t)
                              for t in state.get("generated", ())]
        state["max_new_tokens"] = int(state["max_new_tokens"])
    except (TypeError, ValueError) as exc:
        raise ServingError(f"malformed handoff state: {exc}") from exc
    if not state["prompt"]:
        raise ServingError("handoff state has an empty prompt")
    if state["max_new_tokens"] <= len(state["generated"]):
        raise ServingError(
            "handoff state is already complete "
            f"({len(state['generated'])}/{state['max_new_tokens']} "
            "tokens) — nothing to resume")
    sampling = state.get("sampling")
    if sampling is not None and not isinstance(sampling, dict):
        raise ServingError("handoff sampling must be a dict")
    return state


class _Drain:
    __slots__ = ("replica_id", "deadline", "handoffs")

    def __init__(self, replica_id, deadline):
        self.replica_id = replica_id
        self.deadline = deadline
        self.handoffs = 0


class DrainLedger:
    """Drains in flight, keyed by replica id (thread-safe; the
    monitor tick and reader threads both touch it)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._drains = {}
        self.started = 0
        self.completed = 0
        self.escalated = 0

    def begin(self, replica_id, now, timeout_s):
        """Record a drain order; returns False if one is already in
        flight for this replica (drain is idempotent, not stacking)."""
        with self._lock:
            if replica_id in self._drains:
                return False
            self._drains[replica_id] = _Drain(replica_id,
                                              now + timeout_s)
            self.started += 1
            return True

    def note_handoff(self, replica_id):
        with self._lock:
            d = self._drains.get(replica_id)
            if d is not None:
                d.handoffs += 1

    def finish(self, replica_id, escalated=False):
        """Close out a drain (replica exited or was killed); returns
        its handoff count, or None if no drain was in flight."""
        with self._lock:
            d = self._drains.pop(replica_id, None)
            if d is None:
                return None
            if escalated:
                self.escalated += 1
            else:
                self.completed += 1
            return d.handoffs

    def draining(self, replica_id):
        with self._lock:
            return replica_id in self._drains

    def expired(self, now):
        """Replica ids whose drain deadline has passed (escalation
        candidates for the monitor tick)."""
        with self._lock:
            return [d.replica_id for d in self._drains.values()
                    if now > d.deadline]

    def active(self):
        with self._lock:
            return sorted(self._drains)

    def snapshot(self):
        with self._lock:
            return {"drains_active": len(self._drains),
                    "drains_started": self.started,
                    "drains_completed": self.completed,
                    "drains_escalated": self.escalated}
