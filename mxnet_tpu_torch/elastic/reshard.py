"""Old→new layout deltas for membership transitions
(mxnet_tpu/elastic/reshard.py, over the port's `ShardingPlan` and
`checkpoint_sharded.spec_strings`: the same placements and moves).

A transition changes the world size W, and with it the `{'fsdp': W}`
`ShardingPlan` that decides which rank OWNS which dim-0 slice of each
parameter's optimizer state. This module computes, from the per-param
spec strings `checkpoint_sharded` records (the same `spec_to_str`
syntax, so a transition checkpoint's meta is directly comparable), the
minimal set of rows each member must RECEIVE: rows it owns under the
new placement that it did not own under the old one. Survivors
typically receive a few momentum slices; a joiner receives its full
share; rows whose owner did not change move nothing — that is the
entire point versus a full-restore broadcast, and elasticStats reports
both numbers so the saving is measurable.

Placement convention (single-host-axis mesh): a param whose fitted
spec shards dim 0 over the world axis gives rank r the contiguous row
block [r*d0/W, (r+1)*d0/W); a replicated spec (fit downgraded it —
non-dividing dim, below the fsdp min-size floor, or 0-d) is owned
whole by rank 0. `ShardingPlan._fit` guarantees a spec it sharded
divides evenly, and `placement` re-checks.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..sharding.plan import ShardingPlan

WORLD_AXIS = "fsdp"


def fitted_spec_strings(shapes, world, layout=None, overrides=None):
    """{param: spec string} under a `{'fsdp': world}` mesh — the
    layout identity of one membership generation, in exactly the
    serialization `checkpoint_sharded` writes to bundle meta."""
    from ..checkpoint_sharded import spec_strings

    plan = ShardingPlan({WORLD_AXIS: int(world)}, layout=layout,
                        overrides=overrides)
    specs = plan.resolve({n: tuple(s) for n, s in shapes.items()})
    return spec_strings(specs)


def owner_bounds(spec_str, shape, world):
    """Per-rank dim-0 row bounds [(lo, hi), ...] of one param under
    `spec_str`; non-owners get (0, 0)."""
    world = int(world)
    shape = tuple(shape)
    first = (spec_str or "None").split(",")[0]
    sharded = (len(shape) >= 1 and WORLD_AXIS in first.split("+"))
    if not sharded:
        d0 = shape[0] if shape else 1
        return tuple([(0, d0)] + [(0, 0)] * (world - 1))
    d0 = shape[0]
    if d0 % world != 0:
        raise MXNetError(
            f"spec {spec_str!r} shards dim 0 of {shape} over a world "
            f"of {world}, which does not divide")
    per = d0 // world
    return tuple((r * per, (r + 1) * per) for r in range(world))


def placement(shapes, world, layout=None, overrides=None):
    """{param: per-rank (lo, hi) bounds} for one world size, plus the
    spec strings that produced it. Returns (bounds, spec_strings)."""
    specs = fitted_spec_strings(shapes, world, layout=layout,
                                overrides=overrides)
    bounds = {n: owner_bounds(specs[n], shapes[n], world)
              for n in shapes}
    return bounds, specs


def interval_sub(a, b):
    """Rows of interval `a` not covered by interval `b` (both (lo,
    hi) half-open); at most two pieces, empties dropped."""
    alo, ahi = a
    blo, bhi = b
    out = []
    lo, hi = alo, min(ahi, max(alo, blo))
    if hi > lo:
        out.append((lo, hi))
    lo, hi = max(alo, min(ahi, bhi)), ahi
    if hi > lo:
        out.append((lo, hi))
    return out


def member_moves(old_assign, new_assign):
    """Rows each member must receive: {wid: [(param, lo, hi), ...]}.

    `old_assign`/`new_assign` are {param: {wid: (lo, hi)}} keyed by
    the stable member id (NOT the rank, which reshuffles across a
    transition). A wid absent from `old_assign` is a joiner and
    receives everything it now owns."""
    moves = {}
    params = sorted(new_assign)
    for name in params:
        new_owners = new_assign[name]
        old_owners = old_assign.get(name, {})
        for wid, bounds in sorted(new_owners.items()):
            if bounds[1] <= bounds[0]:
                continue
            had = old_owners.get(wid, (0, 0))
            for lo, hi in interval_sub(bounds, had):
                moves.setdefault(wid, []).append((name, lo, hi))
    return moves


def assignment(bounds, wids_by_rank):
    """Per-rank bounds -> per-wid bounds: {param: {wid: (lo, hi)}}
    (zero-width entries dropped)."""
    out = {}
    for name, per_rank in bounds.items():
        row = {}
        for rank, wid in enumerate(wids_by_rank):
            lo, hi = per_rank[rank]
            if hi > lo:
                row[wid] = (lo, hi)
        out[name] = row
    return out


def row_bytes(shape, dtype=np.float32):
    """Bytes of ONE dim-0 row (itemsize for 0-d)."""
    shape = tuple(shape)
    n = 1
    for d in shape[1:]:
        n *= int(d)
    return n * np.dtype(dtype).itemsize


def moves_bytes(moves, shapes, dtype=np.float32):
    """Total payload bytes a move table transfers."""
    total = 0
    for entries in moves.values():
        for name, lo, hi in entries:
            total += (hi - lo) * row_bytes(shapes[name], dtype)
    return total


def state_bytes(shapes, dtype=np.float32, copies=1):
    """Bytes of `copies` full replicas of the state tree — the
    full-restore baseline a naive transition would broadcast
    (elasticStats reports moved vs this)."""
    total = 0
    for name, shape in shapes.items():
        shape = tuple(shape)
        d0 = shape[0] if shape else 1
        total += d0 * row_bytes(shape, dtype)
    return total * int(copies)
