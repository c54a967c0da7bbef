"""Collectives across the worker processes' gloo group
(`_dist_bootstrap`), on CPU or CUDA tensors.

gloo takes CUDA tensors for all-reduce and broadcast: it copies them to
host memory on a stream of its own that waits for the caller's current
stream, runs the collective on the host, copies the result back, and
the caller's stream waits for that copy (tests/test_torch_dist_cuda.py
holds this under a busy producer stream).

The coalesced forms move many tensors in one collective: one flat
buffer for each (device, dtype), the tensors copied in and back out.

The model-parallel collectives run over the sub-group of a mesh's axes
(`Mesh.group`), its members in shard order. gloo has no CUDA form of
all-gather, reduce-scatter, all-to-all or send/recv, so each of them is
composed here from what it has: all-gather and all-to-all from one
all-reduce over a buffer with a zero slot a member (a sum with zeros is
exact), reduce-scatter from an all-reduce and the member's own slice,
the ring step from paired `isend`/`irecv` of host copies (a CUDA
tensor's copy to the host waits on the caller's stream, and the copy
back is queued on it, so the caller's later work waits on the step),
and a pipeline's boundary from `send`/`recv` between two members of an
axis, under the same discipline.
Each moves the group size times the bytes a native collective would;
with two members that is twice.
"""
from __future__ import annotations

import time

import torch


def all_reduce_(t, group=None):
    """Sum `t` over the group (the default group when None), in place."""
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


def broadcast_(t, src=0):
    """Overwrite `t` with rank `src`'s `t`, in place."""
    import torch.distributed as dist

    dist.broadcast(t, src)
    return t


def all_gather(t, group=None, members=None):
    """Every member's `t`, stacked in member order: (members, *t.shape);
    by default the world's, in rank order. One all-reduce over a buffer
    with a zero slot a member (a sum with zeros is exact), so it takes
    what all-reduce takes."""
    import torch.distributed as dist

    if members is None:
        members = list(range(dist.get_world_size()))
    buf = torch.zeros((len(members),) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    buf[members.index(dist.get_rank())] = t
    return all_reduce_(buf, group)


def _coalesced(op, tensors):
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for idxs in groups.values():
        with torch.no_grad():
            flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
            op(flat)
            off = 0
            for i in idxs:
                n = tensors[i].numel()
                tensors[i].copy_(flat[off:off + n].view(tensors[i].shape))
                off += n
    return tensors


def all_reduce_coalesced_(tensors):
    """Sum each tensor over the group, in place, one collective a
    (device, dtype)."""
    return _coalesced(all_reduce_, list(tensors))


def broadcast_coalesced_(tensors, src=0):
    """Overwrite each tensor with rank `src`'s, one collective a
    (device, dtype)."""
    return _coalesced(lambda f: broadcast_(f, src), list(tensors))


# bytes this process put into its model-parallel collectives, and the
# host seconds they took, by kind (the chip check's "bytes rotated a
# step" and "collectives' ms")
_SENT = {}
_SECONDS = {}


class _count:
    """Count `t`'s bytes under `kind`, and the block's seconds."""

    def __init__(self, kind, t):
        self.kind = kind
        _SENT[kind] = _SENT.get(kind, 0) + t.numel() * t.element_size()

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _SECONDS[self.kind] = _SECONDS.get(self.kind, 0.0) + \
            time.perf_counter() - self.t0
        return False


def sent_bytes():
    """{kind: bytes} this process put into the model-parallel
    collectives since `reset_sent_bytes`."""
    return dict(_SENT)


def collective_seconds():
    """{kind: host seconds} of those collectives (each waits for its
    result, so this is their time on this process)."""
    return dict(_SECONDS)


def reset_sent_bytes():
    _SENT.clear()
    _SECONDS.clear()


def gather_axes(t, mesh, axes, dim):
    """The whole of `t` along `dim`: every member's part of it over the
    mesh axes `axes`, concatenated in shard order (all-gather)."""
    pg, members = mesh.group(axes)
    if len(members) == 1:
        return t
    with _count("all_gather", t):
        return torch.cat(list(all_gather(t.contiguous(), pg, members)
                              .unbind(0)), dim=dim)


def reduce_scatter_axes(t, mesh, axes, dim):
    """This member's part along `dim` of the sum of `t` over the mesh
    axes `axes` (reduce-scatter: the transpose of `gather_axes`)."""
    pg, members = mesh.group(axes)
    if len(members) == 1:
        return t
    import torch.distributed as dist

    with _count("reduce_scatter", t):
        full = t.contiguous().clone()
        dist.all_reduce(full, group=pg)
        return full.chunk(len(members), dim=dim)[
            members.index(dist.get_rank())].contiguous()


def all_reduce_axes_(t, mesh, axes):
    """Sum `t` over the mesh axes `axes`, in place."""
    pg, members = mesh.group(axes)
    if len(members) > 1:
        with _count("all_reduce", t):
            all_reduce_(t, pg)
    return t


def all_to_all_axes(t, mesh, axis, split_dim, concat_dim):
    """`t` split along `split_dim` into one part a member of `axis`, each
    part sent to its member, and the parts received concatenated along
    `concat_dim` in member order (all-to-all)."""
    pg, members = mesh.group((axis,))
    if len(members) == 1:
        return t
    import torch.distributed as dist

    with _count("all_to_all", t):
        everyone = all_gather(t.contiguous(), pg, members)
        me = members.index(dist.get_rank())
        return torch.cat([part.chunk(len(members), dim=split_dim)[me]
                          for part in everyone.unbind(0)], dim=concat_dim)


def ring_shift(tensors, mesh, axis):
    """Each tensor sent to the next member along `axis` and replaced by
    the previous member's (one step of a ring, paired isend/irecv of
    host copies). Returns the received tensors on the senders' device."""
    pg, members = mesh.group((axis,))
    if len(members) == 1:
        return list(tensors)
    import torch.distributed as dist

    me = members.index(dist.get_rank())
    nxt, prv = members[(me + 1) % len(members)], \
        members[(me - 1) % len(members)]
    out, reqs = [], []
    with _count("ring", tensors[0]):
        for i, t in enumerate(tensors):
            if i:
                _SENT["ring"] += t.numel() * t.element_size()
            host = t.detach().contiguous().cpu()
            recv = torch.empty_like(host)
            reqs.append(dist.isend(host, nxt, group=pg))
            reqs.append(dist.irecv(recv, prv, group=pg))
            out.append(recv)
        for r in reqs:
            r.wait()
        return [r.to(t.device) for r, t in zip(out, tensors)]


def send(t, mesh, axis, to):
    """Send `t` to the member at index `to` along the mesh axis `axis`
    (a host copy: on the card the copy waits for the caller's stream).
    Blocks until the member has taken it."""
    import torch.distributed as dist

    pg, members = mesh.group((axis,))
    with _count("p2p", t):
        dist.send(t.detach().contiguous().cpu(), members[to], group=pg)


def recv(shape, dtype, device, mesh, axis, frm):
    """A tensor of `shape` and `dtype` from the member at index `frm`
    along the mesh axis `axis`, on `device` (received on the host; the
    copy to the card is queued on the caller's stream, so the caller's
    later work waits for it)."""
    import torch.distributed as dist

    pg, members = mesh.group((axis,))
    host = torch.empty(tuple(shape), dtype=dtype)
    t0 = time.perf_counter()
    dist.recv(host, members[frm], group=pg)
    _SECONDS["p2p"] = _SECONDS.get("p2p", 0.0) + time.perf_counter() - t0
    return host.to(device)


def barrier():
    import torch.distributed as dist

    dist.barrier()
