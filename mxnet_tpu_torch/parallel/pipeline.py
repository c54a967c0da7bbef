"""Pipeline parallelism over a mesh 'pipe' axis
(mxnet_tpu/parallel/pipeline.py).

The JAX package runs GPipe as one SPMD program: S stages over M
microbatches in S+M-1 ticks, stage s taking microbatch t-s at tick t,
activations rotated one stage a tick by `ppermute`, bubbles computed and
discarded, the last stage's outputs `psum`med to every device. The port
computes the same function:

- in one process the mesh is one device's global program
  (parallel/mesh.py): each active (stage, microbatch) pair runs in the
  JAX package's tick order, and autograd differentiates the composition.
  The bubbles' discarded work and the padded float32 ring buffer are
  artifacts of the SPMD program and are not run; what they do to the
  values is kept: in the heterogeneous form a boundary activation is
  cast to float32 and back to the next stage's input dtype, as the ring
  buffer casts it, and each stage's aux state (BatchNorm's moving
  statistics) is updated once an active microbatch, in order;
- across processes (tools/launch.py) each process holds a contiguous
  block of the stages (`mesh.stage_blocks`). Microbatch by microbatch a
  process receives the boundary activation from the previous process
  along the axis (`collective.recv`), runs its stages and sends the
  result on (`collective.send`); the last process's outputs are
  broadcast over the axis, so every process holds them, as after the
  JAX package's `psum`. Torch autograd does not differentiate through
  send and receive, so the whole schedule is one autograd Function
  (`_Schedule`): its forward keeps each microbatch's graph of this
  process's stages, and its backward runs them back microbatch by
  microbatch with `torch.autograd.backward`, the boundary's gradient
  coming from the next process and going to the previous one, and
  returns the gradients of this process's parameters. Only the last
  process's output gradient enters: the loss every process computes
  from the broadcast outputs is one loss.

Stage parameters are stage-major: leaves with a leading dimension of S,
or, across processes, of this process's block of them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from . import collective
from .mesh import stage_blocks


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _tree_rebuild(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _dtype(d):
    from ..ops.shape_infer import torch_dtype

    return torch_dtype(str(d) if not isinstance(d, torch.dtype) else d)


def _layout(mesh, axis_name, num_stages):
    """(processes along the axis, this process's index, its first stage,
    its stop) of a pipeline of `num_stages` stages over `mesh`."""
    if mesh.shape.get(axis_name) != num_stages and mesh.process_count <= 1:
        raise MXNetError(
            f"a pipeline of {num_stages} stages over mesh axis "
            f"'{axis_name}' of size {mesh.shape.get(axis_name)}")
    blocks = stage_blocks(mesh, num_stages, axis_name)
    index = mesh.axis_index(axis_name) if len(blocks) > 1 else 0
    lo, hi = blocks[index]
    return len(blocks), index, lo, hi


def _check_block(leaf, lo, hi):
    """A stage-major leaf of this process's stages [lo, hi)."""
    if leaf.shape[0] != hi - lo:
        raise MXNetError(
            f"stage-major leaf of {leaf.shape[0]} stages: this process "
            f"holds stages {lo}..{hi - 1}")
    return leaf


class _Schedule(torch.autograd.Function):
    """The pipeline across processes as one autograd Function (module
    docstring). `plan` is a `_CrossPlan`; `leaves` this process's
    parameter tensors."""

    @staticmethod
    def forward(ctx, plan, mbs, *leaves):
        plan.leaves = [x.detach().requires_grad_(x.requires_grad)
                       for x in leaves]
        ctx.plan = plan
        return plan.run_forward(mbs)

    @staticmethod
    def backward(ctx, dout):
        plan = ctx.plan
        grads = plan.run_backward(dout)
        ctx.plan = None
        return (None, None) + tuple(grads)


class _CrossPlan:
    """One pipeline call across processes. `block(m, x, leaves)` runs
    this process's stages on microbatch m from the boundary payload `x`
    (the microbatch itself on the first process) and returns the payload
    it sends on (the pipeline's output on the last process).
    `in_meta`/`out_meta`: (shape, dtype) of the payload received and of
    the pipeline's output."""

    def __init__(self, mesh, axis, nproc, index, m, block, in_meta,
                 out_meta, device):
        self.mesh, self.axis = mesh, axis
        self.nproc, self.index, self.m = nproc, index, m
        self.block = block
        self.in_meta, self.out_meta = in_meta, out_meta
        self.device = device
        self.records = []
        self.leaves = []

    @property
    def first(self):
        return self.index == 0

    @property
    def last(self):
        return self.index == self.nproc - 1

    def run_forward(self, mbs):
        outs = []
        # a microbatch's graph is kept only when a parameter trains
        grad = any(x.requires_grad for x in self.leaves)
        with torch.set_grad_enabled(grad):
            for m in range(self.m):
                if self.first:
                    x = mbs[m]
                else:
                    shape, dt = self.in_meta
                    x = collective.recv(shape, dt, self.device, self.mesh,
                                        self.axis, self.index - 1)
                    if grad and x.is_floating_point():
                        x.requires_grad_(True)
                y = self.block(m, x, self.leaves)
                if not self.last:
                    collective.send(y, self.mesh, self.axis, self.index + 1)
                else:
                    outs.append(y.detach())
                self.records.append((x, y))
        shape, dt = self.out_meta
        out = torch.stack(outs) if self.last else torch.zeros(
            (self.m,) + tuple(shape), dtype=dt, device=self.device)
        pg, members = self.mesh.group((self.axis,))
        import torch.distributed as dist

        with collective._count("pipe_outputs", out):
            dist.broadcast(out, members[-1], group=pg)
        if not grad:
            self.records = []
        return out

    def run_backward(self, dout):
        for m in range(self.m):
            x, y = self.records[m]
            if self.last:
                dy = dout[m].to(y.dtype)
            else:
                dy = collective.recv(y.shape, y.dtype, self.device,
                                     self.mesh, self.axis, self.index + 1)
            if y.requires_grad:
                torch.autograd.backward(y, dy)
            if not self.first:
                g = x.grad if x.grad is not None else torch.zeros_like(x)
                collective.send(g, self.mesh, self.axis, self.index - 1)
        self.records = []
        return [x.grad if x.requires_grad and x.grad is not None
                else (torch.zeros_like(x) if x.requires_grad else None)
                for x in self.leaves]


def pipeline_apply(fn, stage_params, microbatches, mesh,
                   axis_name="pipe"):
    """Run a pipeline of S stages over M microbatches.

    fn(params_for_stage, x, stage_index) -> y   (same shape as x)
    stage_params: pytree (dicts, lists, tuples) of tensors with leading
      dim S (stage-major), S the size of the mesh's `axis_name` in one
      process; across processes this process's block of the stages
      (S is the block times the processes along the axis).
    microbatches: (M, ...) tensor of microbatch inputs (every process
      the same).
    Returns (M, ...) outputs after the last stage, on every process.
    """
    m = microbatches.shape[0]
    rows = _tree_leaves(stage_params)[0].shape[0]
    num_stages = rows * mesh.shape[axis_name] \
        if mesh.process_count > 1 else rows
    nproc, index, lo, hi = _layout(mesh, axis_name, num_stages)
    local = _tree_map(lambda v: _check_block(v, lo, hi), stage_params)
    if nproc == 1:
        acts = list(microbatches.unbind(0))
        for t in range(num_stages + m - 1):
            for st in range(num_stages):
                mb = t - st
                if 0 <= mb < m:
                    acts[mb] = fn(_tree_map(lambda v: v[st], local),
                                  acts[mb], st)
        return torch.stack(acts)

    leaves = _tree_leaves(local)

    def block(mb, x, lv):
        params = _tree_rebuild(local, lv)
        for st in range(lo, hi):
            x = fn(_tree_map(lambda v: v[st - lo], params), x, st)
        return x

    meta = (tuple(microbatches.shape[1:]), microbatches.dtype)
    plan = _CrossPlan(mesh, axis_name, nproc, index, m, block, meta, meta,
                      microbatches.device)
    return _Schedule.apply(plan, microbatches, *leaves)


def pipeline_apply_hetero(stage_fns, flat_params, flat_auxs,
                          microbatches, mesh, axis_name="pipe"):
    """GPipe over heterogeneous stages (the JAX package's contract).

    stage_fns: list of S callables
        fn_s(flat_param_vec, flat_aux_vec, xs, mb_idx)
          -> (ys, new_flat_aux_vec)
      xs a tuple of stage s's inputs (for s=0 the 1-tuple of the
      microbatch), ys a tuple of its outputs; stage s+1's i-th input is
      stage s's i-th output, cast to float32 and to stage s+1's declared
      input dtype (the JAX package's float32 ring buffer). Shapes and
      dtypes are declared by `fn.in_shapes`, `.in_dtypes`, `.out_shapes`,
      `.out_dtypes`; the last stage declares exactly one output.
    flat_params: (S, Lmax) stage-major parameter stack (across processes
      this process's rows of it).
    flat_auxs: (S, Amax) stage-major aux stack (Amax may be 0), likewise.
    microbatches: (M, ...) stage-0 inputs, every process the same.
    Returns ((M, *out_shape_last) outputs on every process, the updated
    aux stack of the rows given).
    """
    s = len(stage_fns)
    m = microbatches.shape[0]
    if len(stage_fns[-1].out_shapes) != 1:
        raise MXNetError("last pipeline stage must have exactly one output")
    nproc, index, lo, hi = _layout(mesh, axis_name, s)
    p_local = _check_block(flat_params, lo, hi)
    a_local = _check_block(flat_auxs, lo, hi)
    auxs = [a_local[i] for i in range(hi - lo)]

    def boundary(ys, nxt):
        return tuple(
            y.to(torch.float32).to(_dtype(dt)).reshape(tuple(sh))
            for y, sh, dt in zip(ys, nxt.in_shapes, nxt.in_dtypes))

    last_shape = tuple(stage_fns[-1].out_shapes[0])
    out_dtype = _dtype(stage_fns[-1].out_dtypes[0])

    if nproc == 1:
        acts = [None] * m
        outs = [None] * m
        pvecs = p_local.unbind(0)
        for t in range(s + m - 1):
            for st in range(s):
                mb = t - st
                if not 0 <= mb < m:
                    continue
                xs = (microbatches[mb],) if st == 0 else acts[mb]
                ys, auxs[st] = stage_fns[st](pvecs[st], auxs[st], xs, mb)
                if st == s - 1:
                    outs[mb] = ys[0]
                else:
                    acts[mb] = boundary(ys, stage_fns[st + 1])
        return torch.stack(outs), torch.stack(auxs)

    def flat(ys):
        return torch.cat([y.reshape(-1).to(torch.float32) for y in ys])

    def block(mb, x, lv):
        (pv,) = lv
        if lo == 0:
            xs = (x,)
        else:
            fn0 = stage_fns[lo]
            xs, off = [], 0
            for sh, dt in zip(fn0.in_shapes, fn0.in_dtypes):
                e = int(np.prod(sh))
                xs.append(x[off:off + e].reshape(tuple(sh)).to(_dtype(dt)))
                off += e
            xs = tuple(xs)
        for st in range(lo, hi):
            ys, auxs[st - lo] = stage_fns[st](pv[st - lo], auxs[st - lo],
                                              xs, mb)
            if st < hi - 1:
                xs = boundary(ys, stage_fns[st + 1])
        return ys[0] if hi == s else flat(ys)

    in_meta = None
    if lo > 0:
        n = sum(int(np.prod(sh)) for sh in stage_fns[lo].in_shapes)
        in_meta = ((n,), torch.float32)
    plan = _CrossPlan(mesh, axis_name, nproc, index, m, block, in_meta,
                      (last_shape, out_dtype), microbatches.device)
    out = _Schedule.apply(plan, microbatches, p_local)
    return out, torch.stack([a.detach() for a in auxs])
