"""Executor: a Symbol bound to device arrays, run eagerly on torch.

The counterpart of mxnet_tpu/executor.py. At bind (`_build`) the symbol
goes through the pass pipeline (`passes.optimize_for_bind`) and the
fusion codegen (`passes.plan_for`), which compiles the bind's group
kernels on the card. `forward` walks the optimized graph node by node in
topological order, skipping the interior of every fused group and
calling its fused callable at the group's output; `forward(is_train=True)`
runs the walk under autograd with the arguments that take gradients as
leaves, and `backward` differentiates the outputs with the given head
gradients or, by default, ones (the loss heads' own gradients ignore
them). BatchNorm's moving statistics are written back after the walk,
outside the autograd graph.

`reshape` binds a new executor for new input shapes, sharing every
array whose shape is unchanged. `group2ctx` places the nodes of each
`ctx_group` (AttrScope) on its context: an input that comes from
another device is copied at the group boundary (the reference's
_CrossDeviceCopy), and simple_bind allocates a grouped variable's arrays
there. `shared_exec` (simple_bind) makes the new executor use the shared
one's argument, gradient and aux arrays for every name of the same
shape and dtype: the buckets of a BucketingModule hold their parameters
once. `cast_compute(dtype)` runs forward and backward in a low-precision
float dtype over float32 master arrays (Module.cast_compute).

A bind resolves to a plan through the process-wide `exec_cache`, keyed
as the JAX package keys its traced programs: a rebind, a reshape back to
a seen shape or a bucket revisit builds no plan, and `shared_exec` with
an equal key short-circuits the table; a plan built on a miss is
recorded in the profiling layer's `deviceStats` (kind "bind"). Before
any plan is built, the HBM pre-flight (`profiling.preflight_bind`)
estimates the bind's footprint against the card's memory. `forward`
records an `executor` event into a running profiler (`profiler.scope`).

`set_monitor_callback(cb)` (the Monitor's hook) makes `forward` first
run the monitored pass, `_forward_monitored`: every node of the
optimized graph in topological order, the interior of each fused group
included, op by op, with `cb("<node>_output", NDArray)` (or
`<node>_output<i>` for an op of several outputs) for each output, as
the JAX package names them. Its random draws are those of the forward
that follows (the generator's and the key chain's state are restored).

The fused train step (`parallel/dp_step.py`) runs the same walk through
`_run_graph` with its own parameter, aux and key values.

Where the exec cache's disk tier is mounted (MXNET_EXEC_CACHE_DIR, or a
serving bundle's overlay), a bind whose plan is not in memory looks for
its record: a compatible one of the same layout (device, sharding
digest, compute dtype) and fusion decisions restores the plan from the
record's walk order, with the group kernels' libraries loaded from the
record's blobs (no nvcc, no parity check, no timing: they were checked
when they were built). It counts `disk_hits`, not `traces`, and lands in
`deviceStats` as a disk load, not a compile. A plan built on a miss
writes its record (`_disk_record_meta`) and libraries for the next
process.
"""
from __future__ import annotations

import json
import os
import time

import torch

from . import exec_cache as _exec_cache
from . import passes as _passes
from . import profiler as _profiler
from . import random as _random
from .base import MXNetError
from .context import as_context
from .ndarray import NDArray
from .symbol import _topo

_STATS = {"executors": 0}


def stats():
    """{"executors": executors this process created}: a
    BucketingModule's revisit of a seen bucket creates none."""
    return dict(_STATS)


def group_devices(group2ctx):
    """{ctx_group: torch.device} of a group2ctx map. Raises MXNetError
    for a context this process cannot reach (a card it does not have):
    a group is never placed elsewhere instead."""
    return {g: as_context(c).torch_device()
            for g, c in (group2ctx or {}).items()}


def _no_grad_positions(opdef, params):
    """The input positions of the op's `no_grad_inputs`: the walk passes
    them detached, so no gradient flows through them (the target and
    decode inputs of the detection ops, labels, indices)."""
    if not opdef.no_grad_inputs:
        return ()
    names = opdef.arg_names_fn(params) if opdef.arg_names_fn is not None \
        else opdef.arg_names
    return tuple(i for i, n in enumerate(names or ())
                 if n in opdef.no_grad_inputs)


class Executor:
    """A Symbol bound to devices and arrays, runnable forward/backward."""

    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states,
                 group2ctx=None, shared_exec=None, sharding=None):
        self._symbol = symbol
        # a ShardingPlan (or None): its digest joins the cache key, so a
        # bind under another plan never shares this bind's plan
        self._sharding_plan = sharding
        self._ctx = as_context(ctx)
        self._device = self._ctx.torch_device()
        self._group2ctx = dict(group2ctx or {})
        self._group_dev = group_devices(self._group2ctx)
        self._compute_dtype = None
        self._keep_dtype = frozenset()
        self.arg_dict = dict(args)
        self.grad_dict = dict(args_grad or {})
        self.aux_dict = dict(aux_states or {})
        self._grad_req = dict(grad_req)
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        missing = [n for n in self._arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        self.arg_arrays = [self.arg_dict[n] for n in self._arg_names]
        self.grad_arrays = [self.grad_dict.get(n) for n in self._arg_names]
        self.aux_arrays = [self.aux_dict[n] for n in self._aux_names]
        self._grad_names = [
            n for n in self._arg_names
            if self._grad_req.get(n, "null") != "null"
            and n in self.grad_dict]
        self.outputs = []
        self._train = None      # (leaves, outputs) of the last train walk
        self._cached_grads = None
        self._monitor_callback = None
        _STATS["executors"] += 1
        self._build(shared_exec)

    # ----------------------------------------------------------- build
    def _build(self, shared_exec=None):
        """Pass pipeline, HBM pre-flight, codegen plan (kernels built and
        checked here on the card, for the compute dtype), then the
        bind's plan from the exec_cache: a `shared_exec` with an equal
        key lends its plan, a hit shares a seen one, a miss builds the
        node plan of the walk."""
        from . import profiling as _profiling

        t_build = time.perf_counter()
        self._opt_symbol = _passes.optimize_for_bind(self._symbol)
        self._monitored_nodes = None
        self._sources = {}   # the walk's constant sources on the device
        if _profiling.profiling_enabled():
            try:
                _profiling.preflight_bind(
                    self._opt_symbol,
                    {n: (tuple(a.shape), a.dtype)
                     for n, a in self.arg_dict.items()},
                    self._grad_req,
                    auxs={n: (tuple(a.shape), a.dtype)
                          for n, a in self.aux_dict.items()},
                    device=self._device)
            except _profiling.HBMPreflightError:
                raise
            except Exception:
                pass  # an estimate that fails never blocks a bind
        raw_key = self._symbol.structure_key()
        graph_key = (raw_key if self._opt_symbol is self._symbol
                     else self._opt_symbol.structure_key())
        # the kernels this bind needs are built in the exec cache's
        # miss path (or loaded from a disk record's blobs)
        pending = _passes.plan_for(
            self._opt_symbol,
            input_shapes={n: tuple(a.shape)
                          for n, a in {**self.arg_dict,
                                       **self.aux_dict}.items()},
            device=self._device, compute_dtype=self._compute_dtype,
            keep_dtype=self._keep_dtype, defer=True)
        mirror = os.environ.get(
            "MXNET_BACKWARD_DO_MIRROR", "0") not in ("0", "", "false")
        # the JAX package's key (with the sharding plan's digest), then
        # the port's own: the device the plan's kernels were built for
        # and the cast_compute dtype they take
        self._cache_key = (
            graph_key,
            tuple(sorted(
                (g, repr(c)) for g, c in self._group2ctx.items())),
            tuple((n, tuple(self.arg_dict[n].shape),
                   str(self.arg_dict[n].dtype))
                  for n in self._arg_names),
            tuple((n, tuple(self.aux_dict[n].shape),
                   str(self.aux_dict[n].dtype))
                  for n in self._aux_names),
            tuple((n, self._grad_req.get(n, "null"))
                  for n in self._arg_names),
            tuple(self._grad_names),
            (self._sharding_plan.digest()
             if self._sharding_plan is not None else None),
            pending.cache_component,
            mirror,
            str(self._device),
            (str(self._compute_dtype), tuple(sorted(self._keep_dtype))),
        )
        if (shared_exec is not None
                and getattr(shared_exec, "_cache_key", None)
                == self._cache_key
                and getattr(shared_exec, "_compiled", None) is not None):
            self._compiled = shared_exec._compiled
            _exec_cache.count_shared_hit()
        else:
            built, restored = [], []

            def make_plan():
                built.append(True)
                return self._make_plan(pending.finish())

            def restore(rec):
                plan = self._restore_plan(pending, rec)
                if plan is not None:
                    restored.append(True)
                return plan

            self._compiled = _exec_cache.lookup_or_build(
                self._cache_key, make_plan, raw_sig=hash(raw_key),
                canonical_fn=lambda: _passes.canonical_digest(
                    self._opt_symbol),
                disk_meta_fn=self._disk_record_meta,
                restore_fn=restore, prepare_fn=pending.finish)
            if built or restored:
                from .profiling import _accounting as _ds

                _ds.record_program(
                    self._compiled.digest, "bind",
                    compile_s=time.perf_counter() - t_build,
                    arg_bytes=_ds.tensor_bytes(
                        [a._data for a in self.arg_dict.values()]
                        + [a._data for a in self.aux_dict.values()]),
                    canonical=self._compiled.canonical,
                    device=self._device, from_disk=not built)
        # on a hit the bind's kernels are in the codegen's table already
        self._codegen_plan = pending.finish()
        self._opt_symbol = self._compiled.opt_symbol

    def _layout(self):
        """What a plan was built for beyond its graph and signature, as
        the disk record keeps it: the device, the sharding plan's digest
        and the compute dtype."""
        return {"device": str(self._device),
                "sharding": (self._sharding_plan.digest()
                             if self._sharding_plan is not None else None),
                "compute": [str(self._compute_dtype),
                            sorted(self._keep_dtype)]}

    def _disk_record_meta(self, entry):
        """What the disk tier keeps of a plan built here: the optimized
        graph's JSON and the bind signature (the JAX package's fields),
        and the port's own: the layout, the fusion decisions, the walk
        order (node index and name in `_topo` order) and the libraries
        the plan launches."""
        return {
            "graph_json": self._opt_symbol.tojson(),
            "inputs": [[n, list(self.arg_dict[n].shape),
                        str(self.arg_dict[n].dtype)]
                       for n in self._arg_names],
            "auxs": [[n, list(self.aux_dict[n].shape),
                      str(self.aux_dict[n].dtype)]
                     for n in self._aux_names],
            "grad_req": {n: self._grad_req.get(n, "null")
                         for n in self._arg_names},
            "sharding": (self._sharding_plan.digest()
                         if self._sharding_plan is not None else None),
            "layout": self._layout(),
            "fusion": [list(c) for c in entry.codegen_plan.cache_component],
            "walk": entry.walk,
            "libraries": [{"kind": tag, "sighash": sig}
                          for tag, sig, _ in
                          entry.codegen_plan.libraries()],
        }

    def _restore_plan(self, pending, rec):
        """The BindPlan of a disk record, or None when the record does not
        fit this bind (another layout or fusion decisions, a walk that
        does not match the graph) or a library blob is missing or fails
        its check: the bind then builds as on a miss."""
        from . import exec_cache_disk as _disk
        from . import kernels as _kernels

        if (rec.get("layout") != json.loads(json.dumps(self._layout()))
                or rec.get("fusion") != [list(c) for c in
                                         pending.cache_component]):
            return None
        for lib in pending.libraries_to_build():
            blob = _disk.load_executable(rec.get("digest"),
                                         *lib[:2])
            if blob is None:
                return None
            _kernels.locate(lib[2], blob)
        walk = rec.get("walk")
        if not isinstance(walk, list):
            return None
        return self._make_plan(pending.finish(restore=True), walk)

    def _make_plan(self, cg, walk=None):
        """The node plan of the walk over the optimized symbol: one
        entry per computed node, a fused group's interior skipped and
        its output routed to the group's kernel handle. `walk` (a disk
        record's [[node index, name], ...]) gives the nodes and their
        order; None when it does not match the graph."""
        nodes = _topo(self._opt_symbol._outputs)
        skip = frozenset(id(nodes[i]) for i in cg.skip)
        fused = {id(nodes[i]): (fn, tuple((id(nodes[s]), oi)
                                          for s, oi in ext))
                 for i, (fn, ext) in cg.fused.items()}
        order = [i for i, n in enumerate(nodes)
                 if not n.is_variable and id(n) not in skip]
        if walk is not None:
            try:
                if [int(i) for i, _ in walk] != order or any(
                        nodes[int(i)].name != name for i, name in walk):
                    return None
            except (TypeError, ValueError):
                return None
        plan = []
        for n in (nodes[i] for i in order):
            params = n.op.normalize_params(n.attrs)
            dev = self._group_dev.get(n._extra_attrs.get("__ctx_group__"))
            plan.append((n.op, params, n.op.resolved_num_outputs(params),
                         [(id(src), i) for src, i in n.inputs], id(n),
                         fused.get(id(n)), _no_grad_positions(n.op, params),
                         dev))
        entry = _exec_cache.BindPlan(
            self._opt_symbol, cg, plan,
            {id(n): n.name for n in nodes if n.is_variable},
            [(id(n), i) for n, i in self._opt_symbol._outputs])
        entry.walk = [[i, nodes[i].name] for i in order]
        return entry

    # ---------------------------------------------------- mixed precision
    def cast_compute(self, dtype, keep=()):
        """Run forward and backward in the float dtype `dtype` (None:
        the arrays' own): floating arguments and aux states are cast to
        it inside the walk, unsigned integer ones promoted to it, the
        names in `keep` (labels) and signed integers left alone. The
        arrays stay as they are (float32 master copies): gradients come
        back through the cast in their dtype and aux updates are written
        back in it. Rebuilds the fusion plan for the compute dtype."""
        from .ops.shape_infer import torch_dtype

        dtype = None if dtype is None else torch_dtype(dtype)
        if dtype is not None and not dtype.is_floating_point:
            raise MXNetError(f"cast_compute takes a float dtype, got {dtype}")
        keep = frozenset(keep)
        rebuild = dtype != self._compute_dtype or (
            dtype is not None and keep != self._keep_dtype)
        self._compute_dtype, self._keep_dtype = dtype, keep
        if rebuild:
            self._build()

    def _cast(self, name, t):
        cdt = self._compute_dtype
        if cdt is None or name in self._keep_dtype:
            return t
        if t.is_floating_point() or (not t.is_signed()
                                     and t.dtype != torch.bool):
            return t.to(cdt)
        return t

    # --------------------------------------------------------- running
    def _run_graph(self, arg_vals, is_train, aux_vals=None, rng=None):
        """The walk: (head outputs, {aux name: updated value}). Aux
        values come from `aux_vals` when given, else the bound arrays;
        with `rng` (a key of the port's JAX key chain, possibly tensors
        on the card) the samplers draw from fold_in(rng, their position
        in the walk) instead of the chain, as the fused step needs."""
        compiled = self._compiled
        env = {}
        aux_set = set(self._aux_names)
        for nid, name in compiled.var_names.items():
            if name in aux_set:
                val = aux_vals[name] if aux_vals is not None \
                    else self.aux_dict[name]._data
            else:
                val = arg_vals[name]
            env[(nid, 0)] = self._cast(name, val)
        aux_updates = {}
        for pos, (opdef, params, n_out, in_keys, nid, fused, no_grad,
                  dev) in enumerate(compiled.plan):
            ins = [env[k] for k in (in_keys if fused is None
                                    else fused[1])]
            if dev is not None:   # the group boundary's copy
                ins = [x.to(dev) for x in ins]
            if fused is not None:
                env[(nid, 0)] = fused[0](*[x.contiguous() for x in ins])
                continue
            for i in no_grad:
                ins[i] = ins[i].detach()
            kwargs = dict(params)
            if opdef.needs_rng == "key":
                kwargs["rng"] = _random.next_key() if rng is None \
                    else _random.fold_in(rng, pos)
            elif opdef.needs_rng:
                kwargs["rng"] = _random.generator(dev or self._device)
            if opdef.needs_mode:
                kwargs["is_train"] = is_train
            constant = not in_keys and not opdef.needs_rng
            res = self._sources.get((pos, is_train)) if constant else None
            if res is None:
                try:
                    res = opdef.fn(*ins, **kwargs)
                    if not isinstance(res, tuple):
                        res = (res,)
                    if not in_keys:  # sources are built on the host
                        res = tuple(r.to(dev or self._device) for r in res)
                        if self._compute_dtype is not None:
                            res = tuple(self._cast(None, r) for r in res)
                except Exception as e:
                    # the op a failure came from, for the fused step's
                    # capture error (an exception may not take
                    # attributes)
                    if getattr(e, "mx_op", None) is None:
                        try:
                            e.mx_op = opdef.name
                        except AttributeError:
                            pass
                    raise
                if constant:
                    # a constant (zeros, ones, an arange): kept on the
                    # device, so a later walk (and a CUDA graph's
                    # capture) copies nothing from the host
                    self._sources[(pos, is_train)] = res
            for i in range(n_out):
                env[(nid, i)] = res[i]
            n_aux = len(opdef.aux_names)
            if n_aux and is_train and len(res) > n_out:
                for (src, _), upd in zip(in_keys[-n_aux:], res[n_out:]):
                    aux_updates[compiled.var_names[src]] = upd
        return [env[k] for k in compiled.heads], aux_updates

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown forward argument {k!r}")
            self.arg_dict[k][:] = v
        if self._monitor_callback is not None:
            self._forward_monitored(is_train)
        arg_vals = {n: self.arg_dict[n]._data for n in self._arg_names}
        self._train = None
        self._cached_grads = None
        with _profiler.scope(
                f"executor_forward[{'train' if is_train else 'eval'}]",
                "executor"):
            if is_train and self._grad_names:
                leaves = {}
                for n in self._grad_names:
                    leaves[n] = arg_vals[n] = \
                        arg_vals[n].detach().requires_grad_(True)
                with torch.enable_grad():
                    outs, aux_upd = self._run_graph(arg_vals, True)
                self._train = (leaves, outs)
            else:
                with torch.no_grad():
                    outs, aux_upd = self._run_graph(arg_vals, is_train)
        if is_train:
            with torch.no_grad():
                for name, val in aux_upd.items():
                    self.aux_dict[name]._data.copy_(val)
        self.outputs = [NDArray(o.detach(), ctx=as_context(o.device))
                        for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last forward(is_train=True) into grad_dict
        (grad_req 'write' or 'add'). Head gradients default to ones."""
        if not self._grad_names:
            return
        if self._train is not None:
            leaves, outs = self._train
            if out_grads is None:
                heads = [torch.ones_like(o) for o in outs]
            else:
                if isinstance(out_grads, NDArray):
                    out_grads = [out_grads]
                heads = [g._data if isinstance(g, NDArray) else g
                         for g in out_grads]
            pairs = [(o, g.to(o.device, o.dtype))
                     for o, g in zip(outs, heads) if o.requires_grad]
            wrt = list(leaves.values())
            grads = torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(wrt)
            self._cached_grads = dict(zip(leaves, grads))
            self._train = None
        elif self._cached_grads is None or out_grads is not None:
            raise MXNetError(
                "backward called without forward(is_train=True)")
        with torch.no_grad():
            for name, g in self._cached_grads.items():
                req = self._grad_req.get(name, "null")
                tgt = self.grad_dict.get(name)
                if tgt is None or req == "null":
                    continue
                if req == "write":
                    if g is None:
                        tgt._data.zero_()
                    elif g is not tgt._data:
                        tgt._data.copy_(g)
                        # the written array stands for the gradient from
                        # now on: the executor holds no second copy
                        self._cached_grads[name] = tgt._data
                elif req == "add":
                    if g is not None:
                        tgt._data.add_(g)
                else:
                    raise MXNetError(f"unknown grad_req {req!r}")

    # -------------------------------------------------------- monitoring
    def set_monitor_callback(self, callback):
        """Call `callback(name, NDArray)` with every node output of each
        forward (the monitored pass, module docstring); None removes
        it."""
        self._monitor_callback = callback

    def _monitor_plan(self):
        """Every computed node of the optimized graph, fused groups'
        interiors included: (opdef, params, n_out, input keys, node id,
        name, device)."""
        if self._monitored_nodes is None:
            plan = []
            for n in _topo(self._opt_symbol._outputs):
                if n.is_variable:
                    continue
                params = n.op.normalize_params(n.attrs)
                plan.append((n.op, params, n.op.resolved_num_outputs(params),
                             [(id(src), i) for src, i in n.inputs], id(n),
                             n.name, self._group_dev.get(
                                 n._extra_attrs.get("__ctx_group__"))))
            self._monitored_nodes = plan
        return self._monitored_nodes

    def _forward_monitored(self, is_train):
        """The monitored pass over the bound arrays: op by op, no fused
        kernel, no autograd, each output handed to the monitor callback.
        The device generator's and the key chain's states are restored
        afterwards, so the forward that follows draws what this pass
        drew."""
        devices = {self._device} | set(self._group_dev.values())
        gens = {d: _random.generator(d) for d in devices}
        saved = {d: g.get_state() for d, g in gens.items()}
        saved_key = getattr(_random._keys, "key", None)
        aux_set = set(self._aux_names)
        env = {}
        for nid, name in self._compiled.var_names.items():
            src = self.aux_dict if name in aux_set else self.arg_dict
            env[(nid, 0)] = self._cast(name, src[name]._data)
        try:
            with torch.no_grad():
                for (opdef, params, n_out, in_keys, nid, nname,
                     dev) in self._monitor_plan():
                    ins = [env[k] for k in in_keys]
                    if dev is not None:
                        ins = [x.to(dev) for x in ins]
                    kwargs = dict(params)
                    if opdef.needs_rng == "key":
                        kwargs["rng"] = _random.next_key()
                    elif opdef.needs_rng:
                        kwargs["rng"] = gens[dev or self._device]
                    if opdef.needs_mode:
                        kwargs["is_train"] = bool(is_train)
                    res = opdef.fn(*ins, **kwargs)
                    if not isinstance(res, tuple):
                        res = (res,)
                    if not in_keys:
                        res = tuple(r.to(dev or self._device) for r in res)
                        if self._compute_dtype is not None:
                            res = tuple(self._cast(None, r) for r in res)
                    for i in range(n_out):
                        env[(nid, i)] = res[i]
                        out_name = (f"{nname}_output" if n_out == 1
                                    else f"{nname}_output{i}")
                        self._monitor_callback(
                            out_name,
                            NDArray(res[i], ctx=as_context(res[i].device)))
        finally:
            for d, g in gens.items():
                g.set_state(saved[d])
            _random._keys.key = saved_key

    # --------------------------------------------------------- utilities
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in (arg_params or {}).items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError(f"unknown argument {name!r}")
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux state {name!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **new_shapes):
        """A new executor bound for the input shapes `new_shapes`,
        sharing the argument, gradient and aux arrays whose shapes do
        not change (new ones are zeros)."""
        from . import ndarray as nd

        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**new_shapes)

        def keep_or_new(cur, shape):
            if tuple(cur.shape) == tuple(shape):
                return cur
            return nd.zeros(shape, ctx=self._ctx, dtype=cur.dtype)

        arg_shape = dict(zip(self._arg_names, arg_shapes))
        new_args = {n: keep_or_new(self.arg_dict[n], arg_shape[n])
                    for n in self._arg_names}
        new_grads = {n: keep_or_new(g, arg_shape[n]) if n in arg_shape
                     else g for n, g in self.grad_dict.items()}
        new_aux = {n: keep_or_new(self.aux_dict[n], s)
                   for n, s in zip(self._aux_names, aux_shapes)}
        # shared_exec=self: a reshape back to seen shapes resolves in
        # the exec_cache (or against this executor) with no new plan
        exe = Executor(self._symbol, self._ctx, new_args, new_grads,
                       self._grad_req, new_aux, group2ctx=self._group2ctx,
                       shared_exec=self)
        exe.cast_compute(self._compute_dtype, self._keep_dtype)
        return exe

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def debug_str(self):
        return self._symbol.debug_str()
