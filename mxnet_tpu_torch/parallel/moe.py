"""Mixture of experts with expert parallelism (mxnet_tpu/parallel/moe.py).

`top1_gating` is the JAX package's Switch-style router, dense: the
(T, E, C) one-hot dispatch and combine tensors and the load-balancing
aux loss. Its softmax is the JAX package's on the host bit for bit: the
same max, the exponential as XLA's CPU backend computes it
(`random.expf32`), a sum over the experts in their order and one
division, so the argmax, the queue positions and the gates agree with
the JAX package's, ties broken toward the first expert by both argmaxes.

`moe_ffn` routes by index instead of through the dense einsums: each kept
token is copied into its (expert, slot) of the (E, C, D) block, the
experts' FFN is one batched matmul pair over the block, and each token
reads its slot back times its gate. The dispatch and combine tensors are
one-hot, so this is the einsums' function exactly: every other term of
their sums is a product with 0. `moe_ffn_plain` keeps the einsums; on
finite inputs the two agree bit for bit (tests/test_torch_pipeline_moe.py).
At a real size the index route is the one that fits: the dense dispatch
of 16,384 tokens to 8 experts of capacity 2,560 is a 1.3 GB tensor and a
1.7e14-operation einsum.

Over a mesh (the ambient one for the MoEFFN op; `mesh=` here):

- in one process the mesh is one device's global program
  (parallel/mesh.py): the whole computation, as on no mesh;
- across processes, an `expert` axis of size p splits no input: every
  process routes the whole token set and computes the FFN of its E/p
  experts (a contiguous block, its coordinate along the axis), and the
  block's outputs are all-gathered over the axis where the JAX package
  constrains `expert_out` to that axis. In backward the gradients of
  the dispatched block and of w1/w2, nonzero on this process's experts
  only, are summed over the axis (the slices are disjoint, so the sum is
  exact) before they reach the router, the layers below and the
  optimizer; every other gradient is whole on each process already and
  is not summed again;
- across processes, a `data` axis feeds each process its rows of the
  global batch, and the gating stays the JAX package's global one: the
  capacity comes from the global token count, a token's place in its
  expert's queue counts the tokens of the processes before this one
  (an exclusive prefix sum of the per-expert counts over the axis, one
  all-gather of E numbers), and the aux loss's two means are global
  (one all-reduce of 2E numbers; in backward each process's share flows
  to its own rows, and the data plane's gradient sum adds the shares).

`stats()` counts the calls and the expert FFN products each computed
(the chip check's "4 of 8 experts a rank").
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError

_STATS = {"calls": 0, "experts_computed": 0, "experts": 0,
          "tokens": 0, "dropped": 0}


def stats():
    """{"calls", "experts_computed", "experts", "tokens", "dropped"}
    summed over `moe_ffn` calls since `reset_stats` (tokens and drops
    are this process's rows)."""
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


class _Exp(torch.autograd.Function):
    """exp with XLA's host bits (`random.expf32`); its gradient is the
    result times the incoming gradient, as jax's exp rule."""

    @staticmethod
    def forward(ctx, x):
        y = _random.expf32(x).to(x.dtype)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def softmax(logits):
    """jax.nn.softmax(logits, axis=-1) with the JAX package's host bits:
    the max held out of the gradient, exp as XLA runs it, the sum in the
    experts' order, one division."""
    m = logits.max(dim=-1, keepdim=True).values.detach()
    e = _Exp.apply(logits - m)
    s = e[..., 0]
    for j in range(1, e.shape[-1]):
        s = s + e[..., j]
    return e / s.unsqueeze(-1)


def top1_gating(logits, num_experts, capacity):
    """Switch-style top-1 router. logits: (T, E). Returns (dispatch
    (T, E, C) one-hot, combine (T, E, C) weights, aux_loss): `_route`'s
    decision written out densely."""
    expert, gate, slot, keep, aux = _route(logits, num_experts, capacity)
    one_hot = torch.nn.functional.one_hot
    dispatch = (one_hot(expert, num_experts)[:, :, None]
                * one_hot(slot, capacity)[:, None, :]).to(
                    torch.float32) * keep[:, None, None]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, aux


def moe_ffn_plain(x, router_w, w1, w2, capacity_factor=1.25):
    """`moe_ffn` through the JAX package's dense einsums, on one device:
    the plain version the index route is held to."""
    e = w1.shape[0]
    capacity = _capacity(x.shape[0], e, capacity_factor, None)
    dispatch, combine, aux = top1_gating(x @ router_w, e, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    h = torch.relu(torch.einsum("ecd,edf->ecf", expert_in, w1))
    expert_out = torch.einsum("ecf,efd->ecd", h, w2)
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    return out, aux


# ------------------------------------------------ collectives with backward
class _GlobalSum(torch.autograd.Function):
    """The sum of `t` over the mesh axis `axis`. Its backward hands each
    process the incoming gradient unchanged: every process computes the
    same global value, the data plane sums the processes' gradients, and
    so each process's rows are counted once."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        from . import collective

        return collective.all_reduce_axes_(t.detach().clone(), mesh,
                                           (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Block(torch.autograd.Function):
    """This process's block [lo, hi) of dimension 0 of a tensor that
    every process holds whole; its backward places the block's gradient
    in a zero tensor of the whole shape and sums it over the mesh axis,
    so every process holds the whole gradient (the blocks are disjoint,
    the sum exact)."""

    @staticmethod
    def forward(ctx, t, lo, hi, mesh, axis):
        ctx.meta = (tuple(t.shape), lo, hi, mesh, axis)
        return t[lo:hi]

    @staticmethod
    def backward(ctx, g):
        from . import collective

        shape, lo, hi, mesh, axis = ctx.meta
        full = g.new_zeros(shape)
        full[lo:hi] = g
        collective.all_reduce_axes_(full, mesh, (axis,))
        return full, None, None, None, None


class _GatherBlocks(torch.autograd.Function):
    """The processes' blocks along the mesh axis, concatenated on
    dimension 0 (all-gather); its backward is this process's block of
    the incoming gradient, which every process computes whole."""

    @staticmethod
    def forward(ctx, t, lo, hi, mesh, axis):
        from . import collective

        ctx.block = (lo, hi)
        return collective.gather_axes(t, mesh, (axis,), 0)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.block
        return g[lo:hi], None, None, None, None


def _axis_across(mesh, axis):
    """(size, this process's index) of `axis` when the mesh spans
    processes along it, else None (one process: the global program)."""
    if mesh is None or axis not in mesh.axis_names \
            or mesh.shape[axis] <= 1 or mesh.process_count <= 1:
        return None
    return mesh.shape[axis], mesh.axis_index(axis)


def _capacity(t, num_experts, capacity_factor, mesh):
    """An expert's queue length for `t` tokens on this process: from
    the global token count over a data axis across processes."""
    data = _axis_across(mesh, "data")
    parts = data[0] if data else 1
    return max(1, int(capacity_factor * (t * parts) / num_experts))


def _route(logits, num_experts, capacity, mesh=None):
    """The router over this process's tokens, global over a data axis
    across processes: (expert, gate, slot position, keep, aux) with the
    queue positions of the global token set."""
    t = logits.shape[0]
    data = _axis_across(mesh, "data")
    parts = data[0] if data else 1
    probs = softmax(logits)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, num_experts).to(
        torch.float32)
    counts = onehot.sum(dim=0)
    pos = torch.cumsum(onehot, dim=0)
    if data:
        from . import collective

        pg, members = mesh.group(("data",))
        every = collective.all_gather(counts.detach(), pg, members)
        me = members.index(_rank())
        pos = pos + every[:me].sum(dim=0)
        counts = every.sum(dim=0)
        psum = _GlobalSum.apply(probs.sum(dim=0), mesh, "data")
    else:
        psum = probs.sum(dim=0)
    pos = pos * onehot - 1.0
    keep = ((pos < capacity) & (onehot > 0)).any(dim=1)
    slot = torch.clamp(pos.gather(1, expert[:, None])[:, 0], 0,
                       capacity - 1).to(torch.int64)
    total = float(t * parts)
    density = counts / total
    aux = torch.sum(density * (psum / total)) * num_experts
    return expert, gate, slot, keep, aux


def _rank():
    import torch.distributed as dist

    return dist.get_rank()


def moe_ffn(x, router_w, w1, w2, capacity_factor=1.25, mesh=None,
            axis_name="expert"):
    """MoE feed-forward. x: (T, D) tokens; router_w: (D, E); w1: (E, D,
    F); w2: (E, F, D). Returns (out (T, D), aux_loss). With `mesh`, the
    experts split over `axis_name` and the gating is global over a
    `data` axis across processes (module docstring)."""
    t, d = x.shape
    e = w1.shape[0]
    if x.device.type == "meta":       # shape inference: no collective
        return x.new_empty((t, d)), x.new_empty(())
    capacity = _capacity(t, e, capacity_factor, mesh)
    expert, gate, slot, keep, aux = _route(x @ router_w, e, capacity,
                                           mesh)
    kept = keep.nonzero()[:, 0]
    ex_idx, sl_idx = expert[kept], slot[kept]
    block = x.new_zeros((e, capacity, d)).index_put((ex_idx, sl_idx),
                                                    x[kept])
    split = _axis_across(mesh, axis_name)
    lo, hi = 0, e
    if split is not None:
        parts, index = split
        if e % parts:
            raise MXNetError(
                f"moe_ffn: {e} experts do not split over the {parts} "
                f"processes of mesh axis '{axis_name}'")
        lo, hi = index * (e // parts), (index + 1) * (e // parts)
        block = _Block.apply(block, lo, hi, mesh, axis_name)
        w1 = _Block.apply(w1, lo, hi, mesh, axis_name)
        w2 = _Block.apply(w2, lo, hi, mesh, axis_name)
    h = torch.relu(torch.bmm(block, w1))
    expert_out = torch.bmm(h, w2)
    if split is not None:
        expert_out = _GatherBlocks.apply(expert_out, lo, hi, mesh,
                                         axis_name)
    picked = expert_out[ex_idx, sl_idx] * gate[kept, None]
    out = x.new_zeros((t, d)).index_put((kept,), picked)
    _STATS["calls"] += 1
    _STATS["experts_computed"] += hi - lo
    _STATS["experts"] += e
    _STATS["tokens"] += t
    _STATS["dropped"] += t - int(kept.numel())
    return out, aux


def init_moe_params(rng, d_model, d_ff, num_experts, dtype=torch.float32,
                    device=None):
    """router_w (D, E), w1 (E, D, F), w2 (E, F, D) drawn from `rng`, a
    key of the port's JAX key chain ((0, seed) is jax.random.PRNGKey(
    seed)): in float32 the JAX package's values bit for bit for the same
    key (another dtype is the float32 draw cast). They are drawn on the
    host and placed on `device`, by default the current context's (the
    card unless the caller names another)."""
    if device is None:
        from ..context import current_context

        device = current_context().torch_device()
    k1, k2, k3 = _split(rng, 3)
    f32 = torch.float32
    scale = torch.tensor(1.0, dtype=f32) / torch.sqrt(
        torch.tensor(float(d_model), dtype=f32))
    scale2 = torch.tensor(1.0, dtype=f32) / torch.sqrt(
        torch.tensor(float(d_ff), dtype=f32))

    def draw(key, shape, s):
        return (_random.normal(key, shape, dtype=f32) * s).to(
            dtype).to(device)

    return {"router_w": draw(k1, (d_model, num_experts), scale),
            "w1": draw(k2, (num_experts, d_model, d_ff), scale),
            "w2": draw(k3, (num_experts, d_ff, d_model), scale2)}


def _split(key, n):
    """jax.random.split(key, n) (the partitionable threefry form: key i
    is the hash of the counter pair (0, i))."""
    return [_random._threefry2x32(key[0], key[1], 0, i) for i in range(n)]
