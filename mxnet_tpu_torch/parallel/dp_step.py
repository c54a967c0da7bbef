"""FusedTrainStep: forward + backward + optimizer update as one step
program (mxnet_tpu/parallel/dp_step.py, its one-device part).

The JAX package traces the step into one donated jit. Here the step
body is the executor's walk (`Executor._run_graph`) with the trainable
parameters as autograd leaves, `torch.autograd.grad` with ones as head
gradients, and the optimizer's `apply_dense` over every trainable
parameter, writing weights, optimizer states and aux states (BatchNorm's
moving statistics) in place over the step's own tensors. Params, states
and auxs live in this object while it is active; the Module copies them
back into the executor's arrays only when a non-fused path needs them.

On the card the body is captured once per input signature as a
`torch.cuda.CUDAGraph`. The first call of a signature runs the body
uncaptured on a side stream: that is the step's real first run, and the
warmup the capture needs (cuDNN's algorithm search, the fusion kernels'
parity checks, lazy library state). The second call captures it on the
same stream; the capture runs nothing, and that call and every later
one copy the batch into the graph's static input buffers, the step's lr
and count t into one static int32 pair (lr's float32 bits and t, from a
pinned host buffer) and replay the graph. The lr scheduler and
`num_update` stay on the host, as in the JAX package; their values
reach the graph through that buffer. Weight decay and lr multipliers
are read at capture, as the JAX package reads them at trace. Dropout
draws from the card's generator, registered with each graph, so every
replay draws new bits; the samplers (needs_rng="key") draw from
fold_in(fold_in(base key, t), node), t read from the static buffer.

A capture or replay that fails raises MXNetError naming the step and
the op; it never continues uncaptured. An op that must synchronise with
the host is marked `capturable=False` in the op registry (Custom, and
the detection ops over NMS), and a random source op draws on the host
at every step: a step whose graph holds one runs the same body
uncaptured on every call, and says so (`graphed` False,
`uncaptured_op` its name, in the deviceStats record). The walk's
constant sources (zeros, ones, an arange) are kept on the device by the
executor after their first run. On the CPU the
same body runs uncaptured: the tests hold it to the JAX step.

`run_steps(data, k, stacked)` advances k steps with no host sync in
between: one host-to-device copy carries every step's (lr, t), and each
step copies its slice of the stacked batch and replays. Kernel launch
counts of the fusion kernels and flash attention count each replay
(`launches.recording` at capture, credited at replay).

`enable_sentinel(spec)` adds the numerics row (numerics/sentinel.py) to
the body: it is computed on the card from the step's outputs,
gradients, pre- and post-update weights, kept on the card, and drained
by `drain_sentinel` in one fetch. MXNET_TPU_FAULT_INJECT=nan:step:N[:p]
poisons parameter p's gradient with NaN at step N, on the card
(`torch.where` on t), so an injected run captures the same graph.

MXNET_TPU_OPT_BUCKET=1 turns on the bucketed update (`_bucket_plan`):
when every trainable parameter has one dtype and one state structure,
the trained parameters become views into one flat buffer, each
optimizer-state leaf views into one flat buffer of its own, and the
step copies its gradients into one flat gradient buffer (one `cat`) and
runs ONE `apply_dense` over the flat tensors, with lr and wd as
per-element vectors where the multipliers differ (static device tensors,
built again only when a multiplier changes). The flat buffers are made
once, when the plan applies; nothing is concatenated or split per step.
`params`, `states`, `get_states`, the sentinel's weights, checkpoints
and the Updater hand-over still see one tensor per parameter (the
views), with the per-parameter path's values and state bytes.
The knob is read when the step is built: a module rebuilds its step
to change it.

`mesh=` (parallel/mesh.py), a mesh whose only axis is `data`, is the
data-parallel form. In one process the Module binds the step's executor
at the global batch, and the step over the global batch is the plain
step on the mesh's one device (GSPMD's semantics: gradients summed over
the data axis, BatchNorm over the global batch). Across worker
processes each worker's executor is bound at its local rows
(`batch_scale` local batches make the global batch): at build every
tensor of the training state is broadcast from rank 0, so ranks seeded
differently start from one lineage; in each step BatchNorm takes the
global batch's statistics (`ops.nn.global_batch_statistics`), the
gradients are summed over the workers' gloo group in one all-reduce a
dtype, and every worker makes the same update. gloo's collectives cannot
be captured in a CUDA graph, so on the card such a step is segments:
forward and backward (a graph, writing the gradients into flat buffers
made at build, or uncaptured when a BatchNorm's statistics need
collectives inside it, as `uncaptured_op` says), the all-reduce (eager),
and the update (a graph). `segments()` names them.

`param_specs`, `data_specs` and `plan=` (a sharding.ShardingPlan) give
the layout over a mesh of the axes data, model, seq, fsdp and tp
(parallel/mesh.py). In one process the step is the plain step on the
mesh's one device, parameters whole; the specs are recorded
(`_param_specs`, the plan's digest joins the profiling digest) and the
body runs under `use_mesh`, so RingAttention runs its ring over the
mesh's shards. Across processes (one process a mesh entry):

- each process stores its shard of every sharded parameter, and of the
  optimizer-state leaves shaped like it (`sharding.lower.
  device_param_bytes` counts them);
- the batch is fed whole along every axis but `data` (whose rows each
  worker feeds), and the step takes this process's slice of each input
  where its spec splits a dimension (`data_specs`, e.g. "None,seq");
- forward gathers every sharded parameter before use (an all-gather
  over its axes); its gradient is the gather's transpose, a
  reduce-scatter over the axes that split the batch (a plain slice
  along one that does not);
- the gradients of replicated parameters are summed over every axis
  that splits the batch (`_split_axes`), one all-reduce a (dtype, axes)
  buffer; every process makes the same update of its own shards;
- the outputs are this process's slice; `whole_outputs` gathers them;
- MoEFFN (parallel/moe.py) computes this process's block of the
  experts over an 'expert' axis, all-gathers the blocks' outputs and
  sums the gradients of the block and of w1/w2 over the axis inside its
  backward (so the data plane's all-reduce leaves them alone), and over
  a 'data' axis gates globally (an all-gather of the per-expert counts
  and an all-reduce of the means);
- RingAttention over an axis that splits dimension 1 of the inputs
  takes this process's sequence shard, over one that splits dimension 0
  its rows of the batch, and over one that splits no input the whole
  sequence (`ring_attention.split_inputs`), as the JAX ring takes
  global arrays in any layout; an axis that splits another dimension
  is refused.

The collectives are gloo's, so on the card forward and backward run
uncaptured when a sharded parameter or a mesh-aware op needs them inside
(`uncaptured_op` says which), and the update stays a graph.
"""
from __future__ import annotations

import contextlib
import logging
import os
import pickle
import time

import numpy as np
import torch

from .. import launches as _launches
from .. import profiler as _profiler
from .. import random as _random
from ..base import MXNetError
from ..ndarray import NDArray
from ..ops import nn as _nn
from . import collective


def parse_nan_inject(spec=None):
    """`fault.parse_nan_inject` ('nan:step:N[:param]'), under the name
    this module gave it before fault.py was ported."""
    from ..fault import parse_nan_inject as parse

    return parse(spec)


def _map_tree(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(_map_tree(fn, t) for t in tree)
    return fn(tree)


def _structure(tree):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(t) for t in tree)
    return "leaf"


def _copy_tree(dst, src):
    """Write `src`'s leaves over `dst`'s tensors (dtype kept)."""
    if dst is None:
        return
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
        return
    dst.copy_(src)


class _Bucket:
    """The bucketed update's storage: flat weight, gradient and state
    buffers that the per-parameter tensors are views of, and the
    (offset, size) of each trainable parameter."""

    __slots__ = ("segs", "weight", "grad", "state", "lr_key", "lr_vec",
                 "wd_key", "wd_vec")

    def __init__(self, segs, weight, grad, state):
        self.segs = segs
        self.weight = weight
        self.grad = grad
        self.state = state
        self.lr_key = self.wd_key = None
        self.lr_vec = self.wd_vec = None


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(structure, leaves):
    """A tree of `structure` (see `_structure`) over an iterator of
    leaves."""
    if structure is None:
        return None
    if isinstance(structure, tuple):
        return tuple(_rebuild(s, leaves) for s in structure)
    return next(leaves)


class _Program:
    """One input signature's step program: its static input buffers and,
    on the card, its CUDA graph with static outputs."""

    __slots__ = ("inputs", "graph", "outs", "row", "launches", "runs",
                 "update_graph", "update_launches")

    def __init__(self, inputs):
        self.inputs = inputs
        self.graph = None
        self.outs = None
        self.row = None
        self.launches = []
        self.runs = 0
        # across processes: the update's graph (graph holds forward and
        # backward)
        self.update_graph = None
        self.update_launches = []


class FusedTrainStep:
    """One step program over (params, opt_states, auxs), owned here while
    the step is active (module docstring)."""

    STATE_FORMAT = "mxnet_tpu/fused_v1"
    # device-resident rows between drains are bounded; a run that never
    # drains drops the oldest
    _SENTINEL_CAP = 4096
    # when True, every step also copies its gradients into `grads`
    # (tensors of the step's own): for checks that compare a step's
    # gradients, at the cost of one copy of them
    retain_grads = False

    def __init__(self, executor, optimizer, param_names, mesh=None,
                 data_axis="data", compute_dtype=None, param_specs=None,
                 data_specs=None, batch_scale=None, logger=logging,
                 plan=None):
        from .mesh import check_mesh

        self._mesh = mesh
        self._data_axis = data_axis
        self._plan = plan
        self._param_specs = dict(param_specs or {})
        self._data_specs = dict(data_specs or {})
        self._nproc = check_mesh(mesh, "the fused train step") \
            if mesh is not None else 1
        self._batch_scale = int(batch_scale) if batch_scale is not None \
            else self._nproc
        self._ex = executor
        self._opt = optimizer
        self._logger = logger
        self._compute_dtype = compute_dtype
        self._device = executor._device

        arg_names = executor._arg_names
        pset = set(param_names)
        self._param_names = [n for n in arg_names if n in pset]
        self._trainable = [
            n for n in self._param_names
            if executor._grad_req.get(n, "null") != "null"]
        self._data_names = [n for n in arg_names if n not in pset]
        self._aux_names = list(executor._aux_names)

        with torch.no_grad():
            self.params = {n: executor.arg_dict[n]._data.detach().clone()
                           for n in self._param_names}
            self.auxs = {n: executor.aux_dict[n]._data.detach().clone()
                         for n in self._aux_names}
        self.states = {
            n: _map_tree(_as_tensor, optimizer.create_state(
                i, executor.arg_dict[n]))
            for i, n in enumerate(self._trainable)}
        # MXNET_TPU_OPT_STATE_DTYPE: states stored in that dtype; a
        # loaded state file converts as it is copied into them
        sdt = os.environ.get("MXNET_TPU_OPT_STATE_DTYPE")
        if sdt:
            self.states = {n: _map_tree(
                lambda x: x.to(getattr(torch, sdt))
                if x.is_floating_point() else x, st)
                for n, st in self.states.items()}
        self.grads = {}
        # parameter bytes re-pointed by `adopt` (fused bucketing)
        self.adopted_bytes = 0
        # across processes: each sharded parameter's sharding, the mesh
        # axes that split the batch, and each input's sharding
        self._shards = {}
        self._split = ()
        self._data_sh = {}
        self._ring_split = {}
        if self._nproc > 1:
            # every process starts from rank 0's whole state, then keeps
            # its shards
            self._broadcast_state()
            self._shard_state()
        self._bucket = None
        self._apply_bucket_plan()
        if mesh is not None:
            self._record_layouts()
        self._base_rng = _random.next_key()
        self._t = 0
        self._use_graphs = self._device.type == "cuda"
        self._programs = {}
        self._pool = None
        self._stream = None
        self.captures = 0
        # device memory the captures reserved (their graph pool's growth)
        self.pool_bytes = 0
        self._flops = 0.0
        plan = executor._compiled.plan
        plan_ops = [entry[0] for entry in plan]
        self._needs_key = any(op.needs_rng == "key" for op in plan_ops)
        self._gen_ops = sorted({op.name for op in plan_ops
                                if op.needs_rng and op.needs_rng != "key"})
        # an op that must synchronise, or a random source the walk draws
        # on the host at every step
        self.uncaptured_op = next(
            (entry[0].name for entry in plan if not entry[0].capturable
             or (entry[0].needs_rng and not entry[3])), None)
        if self._use_graphs and self.uncaptured_op is None \
                and self._gen_ops and not hasattr(
                    torch.cuda.CUDAGraph, "register_generator_state"):
            self.uncaptured_op = (f"{self._gen_ops[0]} (this torch cannot "
                                  "register a generator with a CUDA graph)")
        self.graphed = self._use_graphs and self.uncaptured_op is None
        # across processes: flat gradient buffers (one a dtype) that the
        # all-reduce sums, made once; BatchNorm's statistics need
        # collectives inside forward and backward
        self._grad_flat = {}
        self._grad_view = {}
        self._global_bn = 0
        if self._nproc > 1:
            self._global_bn = sum(
                1 for entry in plan if entry[0].name == "BatchNorm"
                and not entry[1].get("use_global_stats"))
            self._make_grad_buffers()
            self._ring_split = self._ring_layout(plan)
            mesh_ops = sorted({entry[0].name for entry in plan
                               if entry[0].name in _MESH_OPS})
            if self._use_graphs and self.uncaptured_op is None:
                if self._global_bn:
                    self.uncaptured_op = (
                        f"BatchNorm over the global batch "
                        f"({self._global_bn} of them: a gloo collective "
                        "in forward and one in backward each)")
                elif self._shards or mesh_ops:
                    what = [f"{len(self._shards)} sharded parameter(s) "
                            "gathered in forward and reduce-scattered in "
                            "backward"] if self._shards else []
                    what += [f"{op}'s collectives{_MESH_OPS[op]}"
                             for op in mesh_ops]
                    self.uncaptured_op = (
                        "gloo collectives inside forward and backward: "
                        + ", ".join(what))
                self.graphed = self.uncaptured_op is None
        # lr's float32 bits and t, read by the body (on the card, the
        # graphs' static buffer)
        self._scal = torch.zeros(2, dtype=torch.int32, device=self._device)
        self._sentinel = None
        self._sentinel_pending = []   # [(rows (k, C), [(t, lr)], event)]
        self._sentinel_dropped = 0
        self._nan_inj = self._nan_inject_plan()

    # ------------------------------------------------------------ build
    def _make_grad_buffers(self):
        """One flat buffer a (dtype, axes its gradients are summed over)
        over the trainable parameters, and each parameter's gradient as
        a view of it."""
        groups = {}
        for n in self._trainable:
            groups.setdefault((self.params[n].dtype, self._sum_axes(n)),
                              []).append(n)
        for key, names in groups.items():
            flat = torch.zeros(sum(self.params[n].numel() for n in names),
                               dtype=key[0], device=self._device)
            off = 0
            for n in names:
                k = self.params[n].numel()
                self._grad_view[n] = flat[off:off + k].view(
                    self.params[n].shape)
                off += k
            self._grad_flat[key] = flat

    def _sum_axes(self, name):
        """The mesh axes parameter `name`'s gradient is still summed over
        after backward: the axes that split the batch, less those its
        gather's reduce-scatter summed over already."""
        sh = self._shards.get(name)
        done = {a for _d, axes, _p, _i in sh.process_split()
                for a in axes} if sh is not None else set()
        return tuple(a for a in self._split if a not in done)

    def _split_axes(self):
        """The mesh axes (of size > 1) that split the batch: every axis
        named by an input's spec, 'data' for an input without one."""
        from .mesh import PartitionSpec

        mesh, found = self._mesh, set()
        for n in self._data_names:
            spec = self._data_specs.get(n)
            if spec is None:
                spec = PartitionSpec(self._data_axis) \
                    if self._data_axis in mesh.axis_names \
                    else PartitionSpec()
            for entry in spec:
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a in mesh.axis_names and mesh.shape[a] > 1:
                        found.add(a)
        return tuple(a for a in mesh.axis_names if a in found)

    def _shard_state(self):
        """Keep this process's shard of each parameter whose spec splits
        it across processes, and of its optimizer-state leaves of its
        shape; record each input's sharding."""
        from ..sharding.lower import local_part
        from .mesh import NamedSharding, PartitionSpec

        mesh = self._mesh
        self._split = self._split_axes()
        for n in self._data_names:
            spec = self._data_specs.get(n)
            if spec is None and self._data_axis in mesh.axis_names:
                spec = PartitionSpec(self._data_axis)
            self._data_sh[n] = NamedSharding(mesh, spec)
        with torch.no_grad():
            for n in self._param_names:
                sh = NamedSharding(
                    mesh, self._param_specs.get(n, PartitionSpec()))
                if not sh.process_split():
                    continue
                self._shards[n] = sh
                whole = tuple(self.params[n].shape)
                self.params[n] = local_part(self.params[n], sh).clone()
                if n in self.states:
                    self.states[n] = _map_tree(
                        lambda x: local_part(x, sh).clone()
                        if tuple(x.shape) == whole else x, self.states[n])

    def _ring_layout(self, plan):
        """{mesh axis of a RingAttention: the input dimension it splits}
        for the axes that split dimension 0 or 1 of the inputs (an axis
        that splits no input leaves them whole; module docstring).
        Refuses one that splits another dimension."""
        mesh = self._mesh
        dims = {}
        for sh in self._data_sh.values():
            for dim, axes, _p, _i in sh.process_split():
                for a in axes:
                    dims.setdefault(a, set()).add(dim)
            fed = sh.data_split()
            if fed is not None:
                dims.setdefault("data", set()).add(fed[0])
        out = {}
        for axis in sorted({entry[1].get("axis_name", "seq")
                            for entry in plan
                            if entry[0].name == "RingAttention"}):
            if axis not in mesh.axis_names or mesh.shape[axis] <= 1:
                continue
            split = dims.get(axis, set())
            if split in ({0}, {1}):
                out[axis] = min(split)
            elif split:
                raise MXNetError(
                    f"RingAttention over '{axis}': the inputs are split "
                    f"over '{axis}' along dimension(s) {sorted(split)}; "
                    "ring and Ulysses attention take their (B, T, H, D) "
                    "inputs whole or split along the batch or the "
                    f"sequence: give data_shardings that split only "
                    f"dimension 0 or 1 over '{axis}' (e.g. 'None,{axis}')")
        return out

    def _record_layouts(self):
        """`.sharding` on each parameter tensor: its NamedSharding over
        the mesh (in one process the tensor itself is whole on the
        mesh's one device; across processes it is the shard)."""
        from .mesh import NamedSharding, PartitionSpec

        for n, t in self.params.items():
            t.sharding = NamedSharding(
                self._mesh, self._param_specs.get(n, PartitionSpec()))

    def _local_batch(self, data_vals):
        """This process's slice of each input fed whole (module
        docstring); the batch itself in one process."""
        if not self._data_sh:
            return data_vals
        return {n: (v[self._data_sh[n].local_slices(tuple(v.shape))]
                    if n in self._data_sh else v)
                for n, v in data_vals.items()}

    def whole_shapes(self):
        """{parameter: its whole shape} (a shard's is its executor's
        argument shape)."""
        return {n: tuple(self._ex.arg_dict[n].shape)
                for n in self._param_names}

    @property
    def splits_inputs(self):
        """Whether this process is fed whole inputs and steps on its
        slice of them (its outputs are a slice: `whole_outputs`)."""
        return any(sh.process_split() for sh in self._data_sh.values())

    def whole_outputs(self, outs):
        """The step's outputs made whole across processes (a collective:
        every process calls it): an output shaped like this process's
        slice of an input is gathered as that input is split."""
        from ..sharding.lower import gather

        if not self._data_sh:
            return outs
        by_shape = {}
        for n, sh in self._data_sh.items():
            if sh.process_split():
                by_shape.setdefault(
                    tuple(self._ex.arg_dict[n].shape), sh)
        return [gather(o, by_shape[tuple(o.shape)])
                if tuple(o.shape) in by_shape else o for o in outs]

    def _broadcast_state(self):
        """Rank 0's parameters, aux states and optimizer states on every
        worker (one broadcast a dtype)."""
        tensors = list(self.params.values()) + list(self.auxs.values())
        for st in self.states.values():
            tensors += _leaves(st)
        collective.broadcast_coalesced_(tensors, 0)

    def segments(self):
        """What one step runs, in order: each segment's name and how
        (a "graph" replayed, or "uncaptured"); on the CPU and with one
        process, the one body."""
        if self._nproc == 1:
            return [("step", "graph" if self.graphed else "uncaptured")]
        fb = "graph" if self.graphed else "uncaptured"
        up = "graph" if self._use_graphs else "uncaptured"
        summed = sum(1 for _dtype, axes in self._grad_flat if axes)
        return [("forward+backward", fb),
                (f"all-reduce ({summed} buffer(s), gloo)", "uncaptured"),
                ("update", up)]

    def _profiling_digest(self):
        """Accounting key of this step's programs: the executor's
        exec-cache entry digest, plus the sharding plan's digest when
        one governs the layout (the JAX package's key)."""
        digest = getattr(self._ex._compiled, "digest", None)
        if digest and self._plan is not None:
            digest = f"{digest}+{self._plan.digest()[:8]}"
        return digest

    def _nan_inject_plan(self):
        """(param_name, step) for the 'nan:step:N' fault spec, or None;
        read when the step is built. Lazy import: fault.py imports the
        model layer."""
        from ..fault import parse_nan_inject

        spec = parse_nan_inject()
        if spec is None:
            return None
        istep, pname = spec
        if pname is None:
            pname = self._trainable[0] if self._trainable else None
        if pname not in self._trainable:
            self._logger.warning(
                "nan injection target %r is not a trainable parameter "
                "— injection disabled", pname)
            return None
        return (pname, istep)

    def _invalidate(self):
        """Drop every captured graph (the body changed), and their
        memory pool with them: a later capture into the pool of graphs
        that are gone fails in torch's allocator."""
        self._programs.clear()
        self._pool = None

    # -------------------------------------------------- bucketed update
    def _bucket_plan(self):
        """[(name, offset, size)] of the trainable parameters for the
        flat-bucket update (MXNET_TPU_OPT_BUCKET=1), or None when it is
        off or ineligible: the parameters must share one dtype, and
        their optimizer states one structure and one dtype a leaf."""
        if os.environ.get("MXNET_TPU_OPT_BUCKET", "0") != "1":
            return None
        tr = self._trainable
        if not tr:
            return None
        if self._shards:
            # sharded parameters keep their own shards (as the JAX
            # package keeps the bucket to replicated layouts)
            return None
        dtypes = {self.params[n].dtype for n in tr}
        structs = {_structure(self.states[n]) for n in tr}
        leaf_dtypes = {tuple(x.dtype for x in _leaves(self.states[n]))
                       for n in tr}
        if len(dtypes) > 1 or len(structs) > 1 or len(leaf_dtypes) > 1:
            self._logger.info(
                "opt bucket disabled: mixed dtype/state structure "
                "across parameters")
            return None
        segs, off = [], 0
        for n in tr:
            sz = self.params[n].numel()
            segs.append((n, off, sz))
            off += sz
        return segs

    @property
    def _bucket_active(self):
        """Whether the step runs the bucketed update (the JAX package's
        attribute)."""
        return self._bucket is not None

    def _apply_bucket_plan(self):
        """Make the flat buffers when the plan applies: the
        per-parameter tensors become views of them, with their
        values."""
        segs = self._bucket_plan()
        if segs is None:
            return
        tr = self._trainable
        total = segs[-1][1] + segs[-1][2]
        p0 = self.params[tr[0]]
        with torch.no_grad():
            weight = torch.empty(total, dtype=p0.dtype, device=p0.device)
            for n, off, sz in segs:
                view = weight[off:off + sz].view(self.params[n].shape)
                view.copy_(self.params[n])
                self.params[n] = view
            grad = torch.empty_like(weight)
            per_leaf = [_leaves(self.states[n]) for n in tr]
            flat_leaves = []
            for j, leaf0 in enumerate(per_leaf[0]):
                flat = torch.empty(total, dtype=leaf0.dtype,
                                   device=leaf0.device)
                for (n, off, sz), leaves in zip(segs, per_leaf):
                    flat[off:off + sz].view(leaves[j].shape).copy_(
                        leaves[j])
                flat_leaves.append(flat)
            for (n, off, sz) in segs:
                shape = self.params[n].shape
                self.states[n] = _rebuild(
                    _structure(self.states[n]),
                    iter([f[off:off + sz].view(shape)
                          for f in flat_leaves]))
            state = _rebuild(_structure(self.states[tr[0]]),
                             iter(flat_leaves))
        self._bucket = _Bucket(segs, weight, grad, state)

    def _bucket_vector(self, values, key_attr, vec_attr):
        """A static float32 device vector of `values` repeated over each
        parameter's segment, made again only when the values change."""
        b = self._bucket
        key = tuple(values)
        if getattr(b, key_attr) != key:
            parts = [torch.full((sz,), float(v), dtype=torch.float32)
                     for (_n, _o, sz), v in zip(b.segs, values)]
            setattr(b, vec_attr, torch.cat(parts).to(b.weight.device))
            setattr(b, key_attr, key)
        return getattr(b, vec_attr)

    def _bucket_update(self, grads, lr, t):
        """ONE apply_dense over every trainable parameter: gradients
        into the flat gradient buffer, then the flat weight and states
        updated. Returns the flat (new weight, new state)."""
        opt, b = self._opt, self._bucket
        trainable = self._trainable
        torch.cat([grads[n].to(b.weight.dtype).reshape(-1)
                   for n in trainable], out=b.grad)
        lms = [opt._lr_mult_for(n) for n in trainable]
        lr_b = lr
        if any(lm != lms[0] for lm in lms):
            lr_b = lr * self._bucket_vector(lms, "lr_key", "lr_vec")
        elif lms[0] != 1.0:
            lr_b = lr * lms[0]
        wds = [opt._wd_for(n) for n in trainable]
        if opt.wd and any(w != wds[0] for w in wds):
            wd_mult = self._bucket_vector(
                [w / opt.wd for w in wds], "wd_key", "wd_vec")
        else:
            wd_mult = (wds[0] / opt.wd) if opt.wd else 1.0
        with opt.temp_wd_mult("__bucket__", wd_mult):
            return opt.apply_dense("__bucket__", b.weight, b.grad,
                                   b.state, lr_b, t)

    # ------------------------------------------------------------- body
    def _body(self, data, lr, t, count_flops=False):
        """One training step on `data` ({name: tensor}) with lr (0-d
        float32) and t (0-d int32) tensors; returns (outputs, sentinel
        row or None). Writes params, states and auxs in place. With
        `count_flops`, the forward and backward run under torch's
        FlopCounterMode (the update has no operation it counts) and the
        count is kept for `flops()`. Across processes the gradients are
        summed over the workers between backward and the update."""
        outs, grads = self._forward_backward(data, t, count_flops)
        if self._nproc > 1:
            self._sum_grads()
            grads = self._grad_view
        return outs, self._update(outs, grads, lr, t)

    def _forward_backward(self, data, t, count_flops=False):
        """Forward and backward: (outputs, {trainable name: gradient}),
        the aux updates (BatchNorm's moving statistics) written. Across
        processes BatchNorm takes the global batch's statistics and the
        gradients are written into the flat buffers' views."""
        trainable = self._trainable
        rng = _random.fold_in(self._base_rng, t.to(torch.int64)) \
            if self._needs_key else None
        if count_flops:
            from torch.utils.flop_counter import FlopCounterMode

            counter = FlopCounterMode(display=False)
        else:
            counter = contextlib.nullcontext()
        stats = self._batch_stats() if self._global_bn \
            else contextlib.nullcontext()
        shapes = _nn.global_shapes(self._global_shapes(data)) \
            if self.splits_inputs else contextlib.nullcontext()
        with torch.enable_grad(), counter, stats, shapes, self._ambient():
            leaves = {n: self.params[n].detach().requires_grad_(True)
                      for n in trainable}
            args = dict(self.params)
            args.update(leaves)
            if self._shards:
                from ..sharding.lower import gather

                for n, sh in self._shards.items():
                    args[n] = gather(args[n], sh, self._split)
            args.update(self._promote_unsigned(data))
            outs, aux_upd = self._ex._run_graph(
                args, True, aux_vals=self.auxs, rng=rng)
            pairs = [(o, torch.ones_like(o)) for o in outs
                     if o.requires_grad]
            wrt = [leaves[n] for n in trainable]
            got = torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs and wrt else [None] * len(wrt)
        if count_flops:
            self._flops = float(counter.get_total_flops())
        with torch.no_grad():
            grads = {n: (g if g is not None
                         else torch.zeros_like(self.params[n]))
                     for n, g in zip(trainable, got)}
            if self._nan_inj is not None:
                iname, istep = self._nan_inj
                g = grads[iname]
                grads[iname] = torch.where(
                    t == istep, torch.full_like(g, float("nan")), g)
            for k, v in aux_upd.items():
                if k in self.auxs:
                    self.auxs[k].copy_(v)
            if self._nproc > 1:
                for n, g in grads.items():
                    self._grad_view[n].copy_(g)
                grads = self._grad_view
        return [o.detach() for o in outs], grads

    def _global_shapes(self, data):
        """{local shape: global shape} of the inputs this process steps
        on a slice of (ops.nn.global_shapes)."""
        out = {}
        for n, t in data.items():
            sh = self._data_sh.get(n)
            if sh is None or not sh.process_split():
                continue
            shape = list(t.shape)
            for dim, _axes, parts, _index in sh.process_split():
                shape[dim] *= parts
            out[tuple(t.shape)] = tuple(shape)
        return out

    def _batch_stats(self):
        """BatchNorm over the global batch: its statistics' collectives
        over the processes that split the batch."""
        pg, members = self._mesh.group(self._split)
        return _nn.global_batch_statistics(
            lambda t: collective.all_reduce_(t, pg),
            lambda t: collective.all_gather(t, pg, members))

    def _sentinel_reduce(self, key, x, op):
        """A sentinel column made global across processes: a sharded
        parameter's over its shard axes, the outputs' over the axes
        that split the inputs."""
        import torch.distributed as dist

        if key == "outs":
            axes = tuple(a for sh in self._data_sh.values()
                         for _d, ax, _p, _i in sh.process_split()
                         for a in ax)
        elif key in self._shards:
            axes = tuple(a for _d, ax, _p, _i in
                         self._shards[key].process_split() for a in ax)
        else:
            return x
        pg, members = self._mesh.group(tuple(dict.fromkeys(axes)))
        if len(members) == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=pg)
        return x / len(members) if op == "mean" else x

    @contextlib.contextmanager
    def _ambient(self):
        """This step's mesh as the ambient mesh (mesh-aware ops read
        it) and how its inputs are split over the ring attention's axes;
        no-op without a mesh."""
        from . import mesh as mesh_mod
        from .ring_attention import split_inputs

        if self._mesh is None:
            yield
            return
        with mesh_mod.use_mesh(self._mesh), split_inputs(self._ring_split):
            yield

    def _sum_grads(self):
        """Sum the flat gradient buffers over the axes that split the
        batch (eager: gloo's collectives cannot be captured)."""
        for (_dtype, axes), flat in self._grad_flat.items():
            if axes:
                collective.all_reduce_axes_(flat, self._mesh, axes)

    def _update(self, outs, grads, lr, t):
        """The optimizer update of every trainable parameter from
        `grads`, the sentinel row (or None) and the retained gradients."""
        opt = self._opt
        trainable = self._trainable
        with torch.no_grad():
            new = {}
            if self._bucket_active:
                w2, s2 = self._bucket_update(grads, lr, t)
                if self._sentinel is not None:
                    new = {n: (w2[off:off + sz].view(self.params[n].shape),
                               None)
                           for n, off, sz in self._bucket.segs}
                    flat = (w2, s2)
                else:
                    self._bucket.weight.copy_(w2)
                    _copy_tree(self._bucket.state, s2)
            else:
                for name in trainable:
                    w = self.params[name]
                    g = grads[name].to(w.dtype)
                    mult = opt._lr_mult_for(name)
                    lr_p = lr * mult if mult != 1.0 else lr
                    w2, s2 = opt.apply_dense(name, w, g, self.states[name],
                                             lr_p, t)
                    if self._sentinel is not None:
                        new[name] = (w2, s2)
                    else:
                        w.copy_(w2)
                        _copy_tree(self.states[name], s2)
            row = None
            if self._sentinel is not None:
                row = self._sentinel.compute(
                    outs, self.params,
                    {**self.params, **{n: v[0] for n, v in new.items()}},
                    grads, reduce=self._sentinel_reduce
                    if self._shards or self.splits_inputs else None)
                if self._bucket_active:
                    self._bucket.weight.copy_(flat[0])
                    _copy_tree(self._bucket.state, flat[1])
                else:
                    for name, (w2, s2) in new.items():
                        self.params[name].copy_(w2)
                        _copy_tree(self.states[name], s2)
            if self.retain_grads:
                for n, g in grads.items():
                    if n not in self.grads:
                        self.grads[n] = torch.empty_like(g)
                    self.grads[n].copy_(g)
        return row

    def _promote_unsigned(self, data):
        """Unsigned integer batch inputs (uint8 raw-pixel batches) as
        float32 on the device, as the JAX package's step promotes them
        (to the compute dtype under cast_compute, which the executor's
        walk casts to); labels and signed integers are left alone. The
        host-to-device copy stays at the narrow dtype."""
        keep = self._ex._keep_dtype
        return {n: (v.float() if n not in keep and v.dtype in (
                    torch.uint8, torch.uint16, torch.uint32, torch.uint64)
                    else v) for n, v in data.items()}

    # -------------------------------------------------------- scalars
    def _host_scalars(self, lrs, ts):
        """(k, 2) int32 rows of (lr's float32 bits, t)."""
        lr_bits = np.asarray(lrs, np.float32).view(np.int32)
        return np.stack([lr_bits, np.asarray(ts, np.int32)], axis=1)

    def _to_device(self, host, out=None):
        """A host int32 array copied into `out` (a new tensor on the
        step's device when None), without a host sync on the card (a
        pinned buffer, copied asynchronously; torch's pinned allocator
        keeps it until the copy has run)."""
        src = torch.from_numpy(np.ascontiguousarray(host))
        if out is None:
            out = torch.empty(src.shape, dtype=src.dtype,
                              device=self._device)
        if self._device.type != "cuda":
            return out.copy_(src.reshape(out.shape))
        out.copy_(src.pin_memory().reshape(out.shape), non_blocking=True)
        return out

    @contextlib.contextmanager
    def eager(self):
        """Run steps uncaptured inside the block, also on the card, on
        the current stream: the check that a graph's step is the same
        as the uncaptured one."""
        saved, self._use_graphs = self._use_graphs, False
        try:
            yield self
        finally:
            self._use_graphs = saved

    def _lr_t(self):
        return (self._scal[:1].view(torch.float32).reshape(()),
                self._scal[1])

    # --------------------------------------------------------- programs
    def _program(self, data_vals):
        sig = tuple((n, tuple(v.shape), v.dtype)
                    for n, v in sorted(data_vals.items()))
        prog = self._programs.get(sig)
        if prog is None:
            # the bound dtype of each input (a batch converts on copy, as
            # the executor's arrays convert what is written into them)
            bound = self._ex.arg_dict
            inputs = {n: torch.empty(
                tuple(v.shape), device=self._device,
                dtype=bound[n]._data.dtype if n in bound else v.dtype)
                for n, v in data_vals.items()}
            prog = self._programs[sig] = _Program(inputs)
        return prog

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        return self._stream

    def _run_once(self, prog):
        """One step over the values already in prog.inputs and
        self._scal: the uncaptured body (the CPU, the first call of a
        signature on the card, an uncapturable graph), a capture then a
        replay (the second call), or a replay."""
        lr, t = self._lr_t()
        if not self._use_graphs:
            return self._eager(prog, lr, t)
        if self._nproc > 1:
            return self._run_split(prog, lr, t)
        if prog.runs == 0 or not self.graphed:
            return self._eager(prog, lr, t)
        if prog.graph is None:
            self._capture(prog, lr, t)
        try:
            prog.graph.replay()
        except Exception as e:
            raise MXNetError(
                f"replay of the fused train step's CUDA graph failed: "
                f"{type(e).__name__}: {e}") from e
        _launches.credit(prog.launches)
        prog.runs += 1
        outs = [o.clone() for o in prog.outs]
        row = prog.row.clone() if prog.row is not None else None
        return outs, row

    def _eager(self, prog, lr, t):
        """The body uncaptured; on the card on the capture stream, so
        the graph captured next sees the same streams and handles."""
        first = prog.runs == 0
        t0 = time.perf_counter()
        count = first and self._flops == 0.0 and _profiling_on()
        if self._use_graphs:
            side, main = self._side_stream(), \
                torch.cuda.current_stream(self._device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                outs, row = self._body(prog.inputs, lr, t, count)
            main.wait_stream(side)
            for x in outs + ([row] if row is not None else []):
                x.record_stream(main)
        else:
            outs, row = self._body(prog.inputs, lr, t, count)
        prog.runs += 1
        if first and not self.graphed:
            self._record(prog, "fused_step", 0.0,
                         time.perf_counter() - t0, 0, outs, row)
        return outs, row

    def _capture(self, prog, lr, t):
        """Capture the body into prog.graph on the capture stream (it
        runs nothing). Raises MXNetError naming the step and the op."""
        (outs, row), graph, launches, capture_s, grown = \
            self._capture_fn(lambda: self._body(prog.inputs, lr, t))
        prog.graph, prog.outs, prog.row = graph, outs, row
        prog.launches = launches
        self._record(prog, "fused_step", capture_s, 0.0, grown, outs, row)

    def _capture_fn(self, fn):
        """Capture `fn()` into a new graph on the capture stream (nothing
        runs). Returns (fn's result, graph, launches recorded, capture
        seconds, bytes the graph pool grew)."""
        side, main = self._side_stream(), \
            torch.cuda.current_stream(self._device)
        if self._pool is None:
            # one pool for the step's graphs: they replay in the order
            # they were captured, one step at a time
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if self._gen_ops:
            # the generator the body draws from now (a reseed makes a
            # new one): each replay advances it
            graph.register_generator_state(_random.generator(self._device))
        torch.cuda.synchronize(self._device)
        reserved = torch.cuda.memory_reserved(self._device)
        t0 = time.perf_counter()
        try:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                with _launches.recording() as record:
                    graph.capture_begin(pool=self._pool,
                                        capture_error_mode="thread_local")
                    try:
                        result = fn()
                    except BaseException:
                        try:
                            graph.capture_end()
                        except Exception:
                            pass  # the body's error is the one to raise
                        raise
                    graph.capture_end()
            main.wait_stream(side)
        except Exception as e:
            _random.recover_after_failed_capture(self._device)
            op = getattr(e, "mx_op", None)
            where = f" in op {op}" if op else \
                " in its backward or update"
            raise MXNetError(
                f"CUDA graph capture of the fused train step (digest "
                f"{self._profiling_digest()}) failed{where}: "
                f"{type(e).__name__}: {e}") from e
        self.captures += 1
        grown = torch.cuda.memory_reserved(self._device) - reserved
        self.pool_bytes += grown
        return (result, graph, list(record), time.perf_counter() - t0,
                grown)

    def _run_split(self, prog, lr, t):
        """One step across processes on the card, on the capture stream:
        forward and backward (graph, or uncaptured), the gradients'
        all-reduce (eager), then the update (graph). The first call of a
        signature runs every segment uncaptured."""
        side, main = self._side_stream(), \
            torch.cuda.current_stream(self._device)
        if prog.runs == 0:
            t0 = time.perf_counter()
            count = self._flops == 0.0 and _profiling_on()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                outs, row = self._body(prog.inputs, lr, t, count)
                # the outputs the update's graph reads
                prog.outs = [torch.empty_like(o) for o in outs]
            main.wait_stream(side)
            for x in outs + ([row] if row is not None else []):
                x.record_stream(main)
            prog.runs += 1
            self._record(prog, "fused_step", 0.0,
                         time.perf_counter() - t0, 0, outs, row)
            return outs, row

        def forward_backward():
            outs, _ = self._forward_backward(prog.inputs, t)
            for dst, o in zip(prog.outs, outs):
                dst.copy_(o)

        def update():
            return self._update(prog.outs, self._grad_view, lr, t)

        try:
            if self.graphed and prog.graph is None:
                _r, prog.graph, prog.launches, _s, _g = \
                    self._capture_fn(forward_backward)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                if prog.graph is not None:
                    prog.graph.replay()
                    _launches.credit(prog.launches)
                else:
                    forward_backward()
                self._sum_grads()
            # the sentinel's global columns are gloo collectives: that
            # update runs uncaptured
            eager_update = self._sentinel is not None and (
                self._shards or self.splits_inputs)
            if prog.update_graph is None and not eager_update:
                main.wait_stream(side)
                prog.row, prog.update_graph, prog.update_launches, _s, \
                    _g = self._capture_fn(update)
                side.wait_stream(main)
            with torch.cuda.stream(side):
                if eager_update:
                    prog.row = update()
                else:
                    prog.update_graph.replay()
                    _launches.credit(prog.update_launches)
                outs = [o.clone() for o in prog.outs]
                row = prog.row.clone() if prog.row is not None else None
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError(
                f"a segment of the fused train step across processes "
                f"failed: {type(e).__name__}: {e}") from e
        main.wait_stream(side)
        for x in outs + ([row] if row is not None else []):
            x.record_stream(main)
        prog.runs += 1
        return outs, row

    def _record(self, prog, kind, capture_s, warm_s, pool_bytes, outs,
                row):
        from ..profiling import _accounting as _ds

        state = [self.params, self.auxs, prog.inputs, self.states]
        _ds.record_program(
            self._profiling_digest(), kind, compile_s=capture_s,
            trace_s=warm_s, arg_bytes=_ds.tensor_bytes(state),
            out_bytes=_ds.tensor_bytes(outs) + _ds.tensor_bytes(row),
            temp_bytes=pool_bytes, flops=self._flops,
            canonical=getattr(self._ex._compiled, "canonical", None),
            device=self._device, graphed=self.graphed,
            uncaptured_op=self.uncaptured_op)

    # -------------------------------------------------- numerics sentinel
    def enable_sentinel(self, spec):
        """Add a numerics SentinelSpec's row to the step: every step
        then keeps one more row on the card. Drops captured graphs (the
        next call of each signature recaptures). Idempotent for the
        same spec."""
        if self._sentinel is spec:
            return
        self._sentinel = spec
        self._invalidate()

    def _absorb(self, outs, rows, meta):
        """Keep sentinel rows (on the device, no sync) when enabled.
        `meta` is [(t, lr)], one entry a row."""
        if rows is None:
            return outs
        event = None
        if self._device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._sentinel_pending.append((rows, list(meta), event))
        total = sum(len(m) for _r, m, _e in self._sentinel_pending)
        while total > self._SENTINEL_CAP and \
                len(self._sentinel_pending) > 1:
            _r, m, _e = self._sentinel_pending.pop(0)
            total -= len(m)
            self._sentinel_dropped += len(m)
        return outs

    def drain_sentinel(self, wait=True):
        """Move pending sentinel rows to the host in one fetch (counted
        in hostSyncStats like the metric drain). Returns [(t, lr, row)]
        with row a 1-D float32 vector in the spec's column order; []
        (no fetch) when nothing is pending. `wait=False` takes only the
        rows whose step has completed on the device."""
        pending = self._sentinel_pending
        if not pending:
            return []
        if wait:
            take = len(pending)
        else:
            take = 0
            for _rows, _m, event in pending:
                if event is not None and not event.query():
                    break
                take += 1
            if take == 0:
                return []
        self._sentinel_pending = pending[take:]
        pending = pending[:take]
        mats = [r if r.dim() == 2 else r[None] for r, _m, _e in pending]
        host = torch.cat(mats).cpu().numpy()
        _profiler.count_host_sync("blocking_fetches")
        _profiler.count_host_sync("metric_fetches")
        out, at = [], 0
        for _rows, metas, _e in pending:
            for t, lr in metas:
                out.append((int(t), float(lr), host[at]))
                at += 1
        return out

    # -------------------------------------------------------------- run
    def _next_lr(self):
        self._t += 1
        opt = self._opt
        opt.num_update += 1
        return float(opt.lr_scheduler(opt.num_update)
                     if opt.lr_scheduler is not None else opt.lr)

    def _stage(self, prog, data_vals):
        for n, v in data_vals.items():
            prog.inputs[n].copy_(v, non_blocking=True)

    def step(self, data_vals):
        """Run one fused step on {name: tensor} batch inputs. Returns the
        forward outputs; params, states and auxs advance in place."""
        lr = self._next_lr()
        data_vals = self._local_batch(
            {n: _as_tensor(v) for n, v in data_vals.items()})
        with _profiler.scope("fused_train_step", "executor"), \
                torch.profiler.record_function("fused_train_step"):
            prog = self._program(data_vals)
            self._stage(prog, data_vals)
            self._to_device(self._host_scalars([lr], [self._t]),
                            out=self._scal)
            outs, row = self._run_once(prog)
        return self._absorb(outs, None if row is None else row[None],
                            ((self._t, lr),))

    def run_steps(self, data_vals, k, stacked=False):
        """Advance k train steps with no host sync in between: the same
        as k step() calls (per-step lr from the scheduler, t and the
        random draws per step). stacked=False reuses one batch for every
        step; stacked=True takes every value with a leading (k,) axis
        of per-step batches. Returns the last step's outputs."""
        if k < 1:
            raise ValueError("run_steps needs k >= 1")
        lrs, ts = [], []
        for _ in range(k):
            lrs.append(self._next_lr())
            ts.append(self._t)
        data_vals = {n: _as_tensor(v) for n, v in data_vals.items()}
        if self._data_sh:
            # the slice of each step's batch (the stacked axis moved
            # behind the batch's dimensions while slicing)
            if stacked:
                data_vals = {n: v.movedim(0, -1)
                             for n, v in data_vals.items()}
            data_vals = self._local_batch(data_vals)
            if stacked:
                data_vals = {n: v.movedim(-1, 0)
                             for n, v in data_vals.items()}
        rows = []
        with _profiler.scope("fused_train_steps", "executor"), \
                torch.profiler.record_function("fused_train_steps"):
            sched = self._to_device(self._host_scalars(lrs, ts))
            first = {n: v[0] for n, v in data_vals.items()} if stacked \
                else data_vals
            prog = self._program(first)
            fresh = prog.graph is None
            outs = None
            for i in range(k):
                self._stage(prog, {n: v[i] for n, v in data_vals.items()}
                            if stacked else data_vals)
                self._scal.copy_(sched[i])
                outs, row = self._run_once(prog)
                if row is not None:
                    rows.append(row)
            if fresh and prog.graph is not None:
                self._record(prog, f"fused_multi[{int(k)}]", 0.0, 0.0, 0,
                             outs, rows[-1] if rows else None)
        return self._absorb(outs, torch.stack(rows) if rows else None,
                            tuple(zip(ts, lrs)))

    def sync(self):
        """Wait until every queued step has run."""
        _profiler.count_host_sync("blocking_waits")
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # --------------------------------------------------------- teardown
    def load_params(self, arg_params, aux_params):
        """Overwrite the owned parameters/auxs from NDArray dicts (the
        Module calls this when params changed outside the step —
        set_params, init_params(force_init), an eager update)."""
        from ..sharding.lower import local_part

        with torch.no_grad():
            for n in self._param_names:
                src = arg_params[n]._data
                if n in self._shards and tuple(src.shape) != tuple(
                        self.params[n].shape):
                    src = local_part(src, self._shards[n])
                self.params[n].copy_(src)
            for n in self._aux_names:
                self.auxs[n].copy_(aux_params[n]._data)

    def load_states(self, states, t):
        """Overwrite the owned optimizer states ({name: tree}) and the
        step count (a carried or adopted lineage)."""
        with torch.no_grad():
            for n, s in states.items():
                _copy_tree(self.states[n], s)
        self._t = int(t)

    def adopt(self, other):
        """Take `other`'s training state as this step's own (the fused
        bucketing hand-over): its parameter, optimizer-state and aux
        tensors themselves, the bucketed update's flat buffers and the
        step count. Nothing is copied. When the tensors already are this
        step's (each bucket adopted the same storage when it was built),
        the captured graphs stay valid; otherwise they are dropped.
        Returns the bytes of parameters that were re-pointed (0 when the
        storage was already shared)."""
        moved = sum(v.numel() * v.element_size()
                    for n, v in other.params.items()
                    if self.params.get(n) is not v)
        def shared(mine, theirs):
            a, b = _leaves(mine), _leaves(theirs)
            return len(a) == len(b) and all(x is y for x, y in zip(a, b))

        same = moved == 0 and all(
            self.auxs.get(n) is v for n, v in other.auxs.items()) and all(
            shared(self.states.get(n), v) for n, v in other.states.items())
        self.params = dict(other.params)
        self.states = dict(other.states)
        self.auxs = dict(other.auxs)
        self._bucket = other._bucket
        self._t = other._t
        if not same:
            self._invalidate()
        self.adopted_bytes += moved
        return moved

    def snapshot(self):
        """(params, auxs) as copies: the live tensors advance in place
        at the next step. Across processes a sharded parameter is
        gathered whole (a collective: every process calls it)."""
        from ..sharding.lower import gather

        cp = lambda tbl: {k: v.detach().clone() for k, v in tbl.items()}
        params = cp(self.params)
        with torch.no_grad():
            for n, sh in self._shards.items():
                params[n] = gather(params[n], sh)
        return params, cp(self.auxs)

    # ------------------------------------------------------ diagnostics
    def flops(self):
        """Floating-point operations of one step, counted by
        torch.utils.flop_counter.FlopCounterMode over its first run (0
        before that, or with MXNET_PROFILING=0)."""
        return float(self._flops)

    # ------------------------------------------ optimizer state save/load
    def get_states(self):
        host = {n: _map_tree(lambda x: x.detach().cpu().numpy(), s)
                for n, s in self.states.items()}
        return pickle.dumps(
            {"format": self.STATE_FORMAT, "t": self._t, "states": host})

    def set_states(self, blob):
        obj = pickle.loads(blob)
        if isinstance(obj, dict) and obj.get("format") == \
                self.STATE_FORMAT:
            t, host = obj["t"], obj["states"]
        elif isinstance(obj, dict):
            # an eager Updater's states ({index: state}): indices to
            # names through the optimizer's map
            idx2name = self._opt.idx2name
            host = {idx2name[i]: v for i, v in obj.items()
                    if idx2name.get(i) in self.states}
            missing = set(self.states) - set(host)
            if missing:
                raise MXNetError(
                    f"optimizer state file lacks entries for {missing}")
            t = self._opt.num_update
        else:
            raise MXNetError("unrecognized optimizer state format")
        host = {n: _map_tree(lambda x: torch.from_numpy(np.array(
            x.asnumpy() if isinstance(x, NDArray) else x)), v)
            for n, v in host.items()}
        if set(host) != set(self.states) or any(
                _structure(host[n]) != _structure(self.states[n])
                for n in self.states):
            raise MXNetError("optimizer state structure mismatch")
        self.load_states(host, t)


# the mesh-aware ops whose collectives run inside forward and backward
# across processes, and what they are
_MESH_OPS = {
    "RingAttention": "",
    "MoEFFN": (" (the gating's prefix sum and means over 'data', the "
               "experts' all-gather and gradient sums over 'expert')"),
}


def _as_tensor(v):
    return v._data if isinstance(v, NDArray) else torch.as_tensor(v)


def _profiling_on():
    from ..profiling import _accounting as _ds

    return _ds.profiling_enabled()


def supports_fused(optimizer):
    """True when the optimizer overrides the traced apply_dense form."""
    from ..optimizer import Optimizer

    return type(optimizer).apply_dense is not Optimizer.apply_dense
