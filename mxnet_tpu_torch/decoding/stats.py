"""Decode-tier counters and the `decoding_stats()` snapshot.

The decode tier counts TOKENS and PAGES, the units continuous batching
schedules:

  prefill/decode tokens/s   the two throughput regimes, separately
  kv_occupancy              owned pages / pool capacity
  free_low_watermark        fewest free pages ever seen
  preemptions/readmissions  sequences evicted for pages and brought
                            back (re-prefilled)
  p50/p95/p99_token_ms      per-token decode latency
  spec_acceptance_rate      accepted / proposed draft tokens, and
  tokens_per_target_step    tokens emitted per target step (speculative)
  traces_since_warmup       captures (CUDA) or calls at a shape warmup
                            did not visit — must stay 0 in steady state

The snapshot keys are those of the JAX package's `decodingStats` view.
The Prometheus instruments and the view registration belong to the
observability slice (ROADMAP.md A.4) and are not part of this package
yet; `decoding_stats()` reads every live `DecodedModel` directly, and
the `note_*` calls that feed only those instruments in the JAX package
(`note_prefix_reuse`, `note_pool`) record nothing here.
"""
from __future__ import annotations

import threading
from collections import deque

from ..serving.stats import _percentile

_registry_lock = threading.Lock()
_registry: "dict[str, DecodeStats]" = {}

_LATENCY_KEEP = 4096


def _register(key, stats):
    with _registry_lock:
        _registry[key] = stats


def _unregister(key, stats=None):
    with _registry_lock:
        if stats is None or _registry.get(key) is stats:
            _registry.pop(key, None)


def decoding_stats():
    """Snapshot of every live decode model: {"name:version": {...}}."""
    with _registry_lock:
        items = list(_registry.items())
    return {key: st.snapshot() for key, st in items}


def reset_decoding_stats():
    """Zero the counters of every live decode model."""
    with _registry_lock:
        items = list(_registry.values())
    for st in items:
        st.reset()


class DecodeStats:
    """Counters for one decode model. `traces_fn` reads the engine's
    trace counter; `pool_fn` reads the allocator; `depth_fn` reads the
    scheduler's (waiting, active) — all live at snapshot time."""

    def __init__(self, key=None, traces_fn=None, pool_fn=None,
                 depth_fn=None, prefix_fn=None):
        self._key = key or ""
        self._lock = threading.Lock()
        self._traces_fn = traces_fn
        self._pool_fn = pool_fn
        self._depth_fn = depth_fn
        self._prefix_fn = prefix_fn
        self.reset()

    def reset(self):
        with self._lock:
            self.submitted = 0
            self.completed = 0
            self.failed = 0
            self.rejected = 0
            self.expired = 0
            self.cancelled = 0
            self.spec_proposed = 0
            self.spec_accepted = 0
            self.preemptions = 0
            self.readmissions = 0
            self.prefills = 0
            self.prefill_tokens = 0
            self.decode_tokens = 0
            self.steps = 0
            self.nonfinite_logit_steps = 0
            self.nonfinite_logits = 0
            self.quant_clip_steps = 0
            self.quant_clip_values = 0
            self.traces_at_warmup = None
            self._prefill_s = 0.0
            self._decode_s = 0.0
            self._token_lat = deque(maxlen=_LATENCY_KEEP)

    # ------------------------------------------------------ recording
    def note_submitted(self):
        with self._lock:
            self.submitted += 1

    def note_rejected(self):
        with self._lock:
            self.rejected += 1

    def note_expired(self, n=1):
        with self._lock:
            self.expired += n

    def note_cancelled(self, n=1):
        with self._lock:
            self.cancelled += n

    def note_spec(self, proposed, accepted):
        """One speculative step's draft accounting for one row."""
        with self._lock:
            self.spec_proposed += proposed
            self.spec_accepted += accepted

    def note_prefix_reuse(self, pages):
        """Prompt pages mapped from the prefix cache at admission (the
        snapshot's hit/miss detail comes from prefix_fn); feeds only the
        JAX package's Prometheus counter."""

    def note_pool(self):
        """Per-step refresh of the occupancy/bytes gauges; the snapshot
        reads the pool live (pool_fn), so nothing is kept here."""

    def note_failed(self, n=1):
        with self._lock:
            self.failed += n

    def note_completed(self, n=1):
        with self._lock:
            self.completed += n

    def note_prefill(self, tokens, seconds, readmission=False):
        with self._lock:
            self.prefills += 1
            self.prefill_tokens += tokens
            self._prefill_s += seconds
            if readmission:
                self.readmissions += 1

    def note_step(self, live_rows, seconds):
        """One continuous-decode step: `live_rows` tokens emitted."""
        with self._lock:
            self.steps += 1
            self.decode_tokens += live_rows
            self._decode_s += seconds
            if live_rows:
                self._token_lat.append(seconds / live_rows)

    def note_nonfinite(self, rows, steps=1):
        """Guard trip: `rows` active rows produced NaN/Inf logits."""
        with self._lock:
            self.nonfinite_logit_steps += steps
            self.nonfinite_logits += rows

    def note_quant_clips(self, values, steps=1):
        """Guard trip: `values` K/V entries clipped at int8 scatter."""
        with self._lock:
            self.quant_clip_steps += steps
            self.quant_clip_values += values

    def note_preempted(self, n=1):
        with self._lock:
            self.preemptions += n

    def mark_warmup_done(self):
        """Latch the trace floor: anything above it in steady state is a
        call at a shape the warmup grid did not cover."""
        with self._lock:
            self.traces_at_warmup = (
                self._traces_fn() if self._traces_fn else 0)

    # ------------------------------------------------------- snapshot
    def snapshot(self):
        traces_now = self._traces_fn() if self._traces_fn else 0
        pool = self._pool_fn() if self._pool_fn else {}
        prefix = self._prefix_fn() if self._prefix_fn else {}
        waiting, active = self._depth_fn() if self._depth_fn else (0, 0)
        with self._lock:
            lat = sorted(self._token_lat)
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "expired": self.expired,
                "cancelled": self.cancelled,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_acceptance_rate": round(
                    self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else 0.0,
                "tokens_per_target_step": round(
                    self.decode_tokens / self.steps, 3)
                if self.steps else 0.0,
                "preemptions": self.preemptions,
                "readmissions": self.readmissions,
                "prefills": self.prefills,
                "prefill_tokens": self.prefill_tokens,
                "decode_tokens": self.decode_tokens,
                "steps": self.steps,
                "nonfinite_logit_steps": self.nonfinite_logit_steps,
                "nonfinite_logits": self.nonfinite_logits,
                "quant_clip_steps": self.quant_clip_steps,
                "quant_clip_values": self.quant_clip_values,
                "prefill_tokens_per_s": round(
                    self.prefill_tokens / self._prefill_s, 1)
                if self._prefill_s else 0.0,
                "decode_tokens_per_s": round(
                    self.decode_tokens / self._decode_s, 1)
                if self._decode_s else 0.0,
                "p50_token_ms": round(_percentile(lat, 0.50) * 1e3, 3),
                "p95_token_ms": round(_percentile(lat, 0.95) * 1e3, 3),
                "p99_token_ms": round(_percentile(lat, 0.99) * 1e3, 3),
                "traces_since_warmup": (
                    traces_now - self.traces_at_warmup
                    if self.traces_at_warmup is not None else None),
                "waiting": waiting,
                "active": active,
            }
        out.update(pool)
        out.update(prefix)
        return out
