"""Prefix-affinity index: which replica already holds a prompt's KV
pages (mxnet_tpu/fleet/affinity.py).

Replicas advertise their radix-cache contents as page-chain digests
(`PrefixCache.cached_prefixes` — one 8-byte blake2b per page-aligned
prefix, chained so digest equality IS prefix equality). The router
hashes each incoming prompt with the SAME chain (`page_digests`,
same page size as `decoding/blocks.py`) and routes to the replica
whose advertised set covers the LONGEST leading run of the prompt's
page digests: every covered page is page_size tokens of prefill that
replica will map from its cache instead of recomputing — which is
how the per-process prefix cache becomes a fleet-wide asset.

No token ever crosses the wire for routing: digests only. A stale or
collided digest costs one suboptimal placement, never correctness
(the replica-side cache matches exact tokens).
"""
from __future__ import annotations

import threading

from ..decoding.prefix import page_digests


class AffinityIndex:
    """Advertised cached-prefix digests per replica + best-replica
    lookup. Thread-safe: heartbeats update it while the routing path
    reads it."""

    def __init__(self, page_size, kv_dtype="float32"):
        self.page_size = int(page_size)
        # the fleet's KV storage precision: prompt chains are seeded
        # with it (decoding.prefix._chain_seed), so an advertisement
        # recorded at another dtype can never cover a single page —
        # affinity silently degrades to least-loaded instead of
        # routing to a replica whose pages hold a different encoding
        self.kv_dtype = kv_dtype
        self._lock = threading.Lock()
        self._sets = {}          # replica id -> set of hex digests

    def update(self, replica_id, digests):
        with self._lock:
            self._sets[replica_id] = set(digests)

    def remove(self, replica_id):
        with self._lock:
            self._sets.pop(replica_id, None)

    def advertised(self, replica_id):
        with self._lock:
            return set(self._sets.get(replica_id, ()))

    def best(self, prompt, candidates):
        """(replica_id, pages_covered) for the candidate whose
        advertisement covers the longest leading run of `prompt`'s
        page digests; (None, 0) when no candidate covers even the
        first page (caller falls back to least-loaded)."""
        chain = page_digests(prompt, self.page_size, self.kv_dtype)
        if not chain:
            return None, 0
        best_rid, best_cover = None, 0
        with self._lock:
            for rid in candidates:
                adv = self._sets.get(rid)
                if not adv:
                    continue
                cover = 0
                for d in chain:
                    if d not in adv:
                        break
                    cover += 1
                if cover > best_cover:
                    best_rid, best_cover = rid, cover
        return best_rid, best_cover
