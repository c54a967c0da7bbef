"""Module: Symbol + contexts -> trainable model
(mxnet_tpu/module/module.py).

bind / init_params / set_params / get_params / init_optimizer /
forward / backward / update / update_metric, driven by BaseModule.fit.
The Module keeps master copies of the parameters (`_arg_params`,
`_aux_params`) beside the executor's arrays, as the JAX package does,
and synchronizes them on get_params.

The lifecycle around training: `save_checkpoint` writes
prefix-symbol.json, prefix-%04d.params and, when asked, the optimizer's
prefix-%04d.states (`Updater.get_states`, the JAX package's pickle);
`Module.load` builds a module from them, its parameters on the module's
device, and loads the states at `init_optimizer`; `reshape` rebinds for
new input shapes, sharing the parameter and gradient arrays;
`borrow_optimizer` shares another module's optimizer and states.

`bind(shared_module=m)` binds beside `m` (a bucket beside the default
bucket): the executors use `m`'s parameter, gradient and aux arrays, the
module adopts `m`'s master dicts and, when `m` has one, its optimizer.
`cast_compute(dtype)` trains in a low-precision float dtype over float32
master weights (the JAX package's fused-step semantics).

The fused train step (parallel/dp_step.py), as in the JAX package:
`init_optimizer` builds one when the configuration allows it (no state
inputs, no input gradients, no eager monitor, grad_req 'write' on every
trained parameter, an optimizer with `apply_dense`). It owns the
training state while active: `forward(is_train=True)` only stages the
batch, `update()` runs the whole step (on the card a replay of its CUDA
graph) and `get_outputs`/`update_metric` read its outputs. Every other
path sees current values: `get_outputs` or `update_metric` before
`update` replays the staged batch through the executor (the eager
lifecycle for that batch), `backward(out_grads)` does the same, an eager
forward or `get_params` flushes the step's parameters back, `set_params`
or an eager update makes the step reload them (and fold the eager
updater's optimizer state in) before its next run, and
`_disable_fused` hands its optimizer state to the eager updater.
`run_steps(batch, k, stacked)` advances k steps without a host sync in
between. The optimizer-state files of `save_optimizer_states` are the
fused step's format while it is active; both formats load into either
path.

`install_monitor(Monitor(...))` runs every forward through the
executor's monitored pass and therefore trains eagerly, as in the JAX
package; `Monitor(device=True)` keeps the fused step and reads the
numerics sentinel row instead (`_ensure_sentinel`).

Fused bucketing (MXNET_TPU_BUCKET_FUSED=1, the JAX package's
`_adopt_fused`): a module bound beside a shared module keeps the shared
module's fused step, and `borrow_optimizer` builds this module its own
step (its own captured graphs, for its own shapes) that adopts the
lender's canonical training state at once. Adoption shares the step's
parameter, optimizer-state and aux tensors themselves (and the bucketed
update's flat buffers): every bucket's graphs capture over the one
storage, so a later hand-over moves the step count and the coherence
flags and copies no parameter. The previous owner is marked
surrendered: it neither flushes nor hands its (shared) state to an
eager updater. The default keeps the shared-array eager updates.

Several contexts, as in the JAX package. The executor group binds one
executor a context on its slice of the batch, and `model._create_kvstore`
picks the store ('local', 'device', 'dist_sync', 'dist_async', 'tpu'):
the eager update pushes every gradient to it and pulls the weights
(`update_on_kvstore`), or pushes and pulls the gradients and runs the
updater on each copy. With kvstore 'tpu' over distinct contexts (or
`mesh_shape={"data": n}`) the fused step trains over a data mesh
(parallel/mesh.py): in one process that is the step over the global
batch, run by an executor bound at the global batch on the contexts'
one device (distinct CUDA cards in one process are refused: one process
a card, under tools/launch.py). The same context twice (`[gpu(0),
gpu(0)]`) builds no mesh and keeps the executor group, as in the JAX
package. Across worker processes (tools/launch.py, kvstore 'dist_sync'
or 'tpu') the fused step's data plane sums the gradients over the
workers and takes BatchNorm's statistics over the global batch; each
worker feeds and reads back its own rows, and the gradients are
normalized by the global batch (`_multiproc_mesh_plan`). dist_async
keeps the eager path: its server applies each push as it arrives.

Model parallelism (the JAX package's `mesh_shape`, `data_shardings` and
`sharding=`): `mesh_shape` takes every mesh axis of the JAX package
(data, model, seq, pipe, expert, fsdp, tp; a MoEFFN op reads the
`expert` and `data` axes, parallel/moe.py, and pipelines are
PipelineModule's); parameters follow their Symbol `__sharding__` attributes (axes the mesh
lacks are ignored with a warning), `data_shardings` ({input: spec})
splits inputs, e.g. {'data': 'None,seq'}, and a `sharding.ShardingPlan`
adds its rule table (explicit plan overrides > Symbol attributes > plan
rules), verified before any executor is built. In one process the mesh
is one device's global step (parallel/mesh.py); across processes each
process is one entry of the mesh, stores its shards, is fed the whole
batch along every axis but `data`, and `get_outputs` gathers the
outputs (a collective). `_multiproc_mesh_plan` is the JAX package's
decision of whether a mesh_shape is usable across processes.
"""
from __future__ import annotations

import logging

import numpy as np

import torch

from .. import _dist_bootstrap
from .. import context as _context
from .. import metric as _metric
from .. import ndarray as nd
from .. import optimizer as opt
from .. import utils as _utils
from ..base import MXNetError
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup


def params_from_jax(arg_params, aux_params, ctx=None):
    """The port's (arg_params, aux_params) NDArray dicts on `ctx` (the
    card when None) from the JAX package's `Module.get_params()` output,
    or any dicts of numpy-convertible arrays (objects with `asnumpy()`
    are read through it). Use with `Module.set_params`."""
    ctx = _context.current_context() if ctx is None else ctx

    def convert(table):
        return {name: nd.array(v.asnumpy() if hasattr(v, "asnumpy")
                               else np.asarray(v), ctx=ctx)
                for name, v in (table or {}).items()}

    return convert(arg_params), convert(aux_params)


def _check_mesh_shape(mesh_shape):
    """{axis: size} of a mesh (`parallel.mesh.check_axes` refuses an
    unknown axis)."""
    from ..parallel.mesh import check_axes

    shape = {str(k): int(v) for k, v in dict(mesh_shape).items()}
    check_axes(shape, "mesh_shape")
    return shape


class Module(BaseModule):
    """The trainer for one Symbol over one or several contexts."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, mesh_shape=None, data_shardings=None,
                 sharding=None):
        super().__init__(logger=logger)
        self._sharding_plan = sharding
        if sharding is not None:
            if mesh_shape and dict(mesh_shape) != sharding.axis_sizes:
                self.logger.warning(
                    "both mesh_shape %s and a sharding plan (mesh %s) "
                    "given; the plan's mesh wins", dict(mesh_shape),
                    sharding.axis_sizes)
            mesh_shape = sharding.axis_sizes
        self._mesh_shape = _check_mesh_shape(mesh_shape) if mesh_shape \
            else None
        self._data_shardings = dict(data_shardings or {})
        if context is None:
            context = _context.current_context()
        if isinstance(context, _context.Context):
            context = [context]
        context = [_context.as_context(c) for c in context]
        for c in context:
            c.torch_device()  # raises when the card is missing
        if work_load_list is None:
            work_load_list = [1] * len(context)
        if len(work_load_list) != len(context):
            raise MXNetError(f"work_load_list has {len(work_load_list)} "
                             f"entries for {len(context)} contexts")
        self._work_load_list = list(work_load_list)
        self._context = context
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names or [])
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._preload_opt_states = None
        self._compute_dtype = None
        # the fused train step (parallel/dp_step.py); None: eager path
        self._fused_step = None
        self._fused_dirty = False
        self._fused_stale = False
        # optimizer-state lineage across the fused/eager boundary
        self._eager_seed_t = 0
        self._opt_state_bifurcated = False
        # fused bucketing: another bucket's step owns the canonical state
        self._fused_surrendered = False
        self._staged_batch = None
        self._staged_vals = None
        self._staged_outputs = None
        self._staged_backward = False
        self._monitor = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of the checkpoint `prefix`-`epoch` (its parameters on
        the module's device); with `load_optimizer_states` the states
        file is loaded at `init_optimizer`."""
        symbol, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=symbol, **kwargs)
        ctx = mod._context[0]
        mod._arg_params = {k: v.copyto(ctx) for k, v in args.items()}
        mod._aux_params = {k: v.copyto(ctx) for k, v in auxs.items()}
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write prefix-symbol.json, prefix-%04d.params and, with
        `save_optimizer_states`, prefix-%04d.states."""
        self._symbol.save(f"{prefix}-symbol.json")
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._fused_step is None and self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as fout:
            fout.write(self._fused_step.get_states()
                       if self._fused_step is not None
                       else self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._fused_step is None and self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as fin:
            blob = fin.read()
        if self._fused_step is not None:
            self._fused_step.set_states(blob)
        else:
            self._updater.set_states(blob)

    # ------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._exec_group.get_output_shapes()

    # ------------------------------------------------------- parameters
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _sync_params_from_devices(self):
        if self._fused_step is not None and self._fused_dirty:
            self._flush_fused()
        else:
            self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill parameters from the given dicts when present, from the
        initializer otherwise, then copy them to the executor."""
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and "
                            "force_init=False. init_params call ignored.")
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        # what the fused step trained and never flushed lands in the
        # master dicts first: entries missing from the given dicts keep
        # their trained values
        self._flush_fused()
        attrs = self._symbol.attr_dict()
        changed = False

        def fill(table, source):
            nonlocal changed
            for name, arr in table.items():
                given = None if source is None else source.get(name)
                if given is not None:
                    if given is not arr:
                        if isinstance(given, nd.NDArray):
                            given.copyto(arr)
                        else:
                            arr[:] = given
                        changed = True
                    continue
                if source is not None and not allow_missing:
                    raise RuntimeError(f"{name} is not presented")
                if initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), arr)
                    changed = True

        fill(self._arg_params, arg_params)
        fill(self._aux_params, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        if self._fused_step is not None and changed:
            # the values moved (fit's epoch-end get_params/set_params
            # round trip moves nothing and reloads nothing)
            self._fused_dirty = False
            self._fused_stale = True
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and "
                            "force_init=False. set_params call ignored.")
            return
        self._flush_fused()
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True
        if self._fused_step is not None:
            self._fused_stale = True

    # ---------------------------------------------------------- binding
    @staticmethod
    def _as_descs(shapes):
        if not shapes:
            return None
        return [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1])
                for s in shapes]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", sharding=None):
        """Bind the executor for these shapes (building the bind's
        fusion kernels on the card). `sharding` (a ShardingPlan) sets
        the module's plan for this bind; its explicit overrides are
        verified against the inferred parameter shapes before any
        executor is built (GraphVerifyError names the parameter, the
        axis and both sizes)."""
        if sharding is not None:
            self._sharding_plan = sharding
            self._mesh_shape = _check_mesh_shape(sharding.axis_sizes)
        if self._sharding_plan is not None and (
                force_rebind or not self.binded):
            self._verify_sharding_plan(data_shapes, label_shapes)
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None and not (
                shared_module.binded and shared_module.params_initialized):
            raise MXNetError("shared_module must be bound and initialized")
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad requires for_training")
        if shared_module is not None and not _utils.getenv(
                "MXNET_TPU_BUCKET_FUSED"):
            # modules that share executors update parameters through
            # the shared arrays: a fused step owning them cannot stay
            # (MXNET_TPU_BUCKET_FUSED keeps it: each bucket gets its own
            # step, handed the canonical state at a switch)
            shared_module._disable_fused(
                "module is shared (bucketing); reverting to eager updates")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = self._as_descs(data_shapes)
        self._label_shapes = self._as_descs(label_shapes)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad,
            None if shared_module is None else shared_module._exec_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names)
        self._apply_compute_dtype()
        if shared_module is not None:
            # the executors hold the shared module's arrays; its master
            # dicts are this module's too
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
            return
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
            return

        def alloc(names, blocks):
            return {name: nd.zeros(block[0].shape, dtype=block[0].dtype,
                                   ctx=block[0].context)
                    for name, block in zip(names, blocks)}

        self._arg_params = alloc(self._param_names,
                                 self._exec_group.param_arrays)
        self._aux_params = alloc(self._aux_names,
                                 self._exec_group.aux_arrays)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._fused_step is not None:
            # re-initialized mid-training: keep the step's progress
            self._flush_fused()
            self._fused_step = None
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params,
            plan=self._sharding_plan)
        # gradients are normalized by the global batch: every context's
        # rows, and every worker's under a synchronous distributed store
        global_batch = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            global_batch *= kvstore.num_workers
        elif kvstore and "tpu" in kvstore.type and kvstore.num_workers > 1:
            global_batch *= self._multiproc_mesh_plan()[1]
        rescale_grad = 1.0 / global_batch
        if isinstance(optimizer, str):
            # the eager update gives each (parameter, context) pair an
            # index of its own, so each copy has its own state
            ndev = 1 if update_on_kvstore else len(self._context)
            idx2name = {i * ndev + k: n
                        for i, n in enumerate(self._exec_group.param_names)
                        for k in range(ndev)}
            settings = dict(optimizer_params or ())
            settings.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name, **settings)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but rescale_grad "
                "is not normalized to 1.0/batch_size/num_workers (%s vs. "
                "%s). Is this intended?", optimizer.rescale_grad,
                rescale_grad)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            # the store starts from these parameters (rank 0's across
            # processes)
            _initialize_kvstore(
                kvstore=kvstore, param_arrays=self._exec_group.param_arrays,
                arg_params=self._arg_params, param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        self._build_fused_step()
        if (kvstore and "tpu" in kvstore.type and kvstore.num_workers > 1
                and self._fused_step is None):
            # the eager path's push sums the gradients of every worker
            expected = 1.0 / (self._exec_group.batch_size
                              * kvstore.num_workers)
            if self._optimizer.rescale_grad != expected:
                self.logger.warning(
                    "fused train step unavailable; the eager "
                    "kvstore('tpu') path sums gradients over %d workers "
                    "— adjusting rescale_grad %g -> %g",
                    kvstore.num_workers, self._optimizer.rescale_grad,
                    expected)
                self._optimizer.rescale_grad = expected
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _eager_updater(self):
        """The updater the eager update drives: the module's, or the
        store's when the optimizer runs on the store."""
        if self._updater is not None:
            return self._updater
        if self._kvstore is not None:
            return getattr(self._kvstore, "_updater", None)
        return None

    # ----------------------------------------------- fused train step
    def _verify_sharding_plan(self, data_shapes, label_shapes):
        """Reject the plan's explicit overrides whose mesh-axis sizes do
        not divide the inferred parameter shapes, before any executor is
        built (analysis.graph_verify.verify_sharding). An inference
        failure is left to the bind's own diagnostics."""
        from ..analysis import graph_verify as _gv

        known = {}
        for d in (self._as_descs(data_shapes) or []) + (
                self._as_descs(label_shapes) or []):
            known[d.name] = tuple(d.shape)
        try:
            arg_shapes, _, _ = self._symbol.infer_shape(**known)
            names = self._symbol.list_arguments()
        except Exception:
            return
        if arg_shapes is None:
            return
        params = set(self._param_names)
        _gv.verify_sharding(self._sharding_plan, {
            n: tuple(sh) for n, sh in zip(names, arg_shapes)
            if n in params and sh is not None})

    def _multiproc_mesh_plan(self):
        """(mesh_shape usable across the processes, batch_scale): how many
        local batches make a global batch across worker processes. The
        one decision init_optimizer (rescale_grad) and _build_fused_step
        share; the JAX package's: a mesh_shape is used when it covers
        every process (one entry a process) and its 'data' axis, if any,
        divides by the process count; each process then feeds its rows
        of the data axis (scale nproc) or, without one, the whole batch
        (scale 1). Otherwise a 1-D data mesh over the processes."""
        import math

        nproc = _dist_bootstrap.process_count()
        if nproc <= 1:
            return (False, 1)
        ms = self._mesh_shape
        if ms:
            d = ms.get("data", 1)
            if math.prod(ms.values()) == nproc and (
                    "data" not in ms or d % nproc == 0):
                return (True, nproc if "data" in ms else 1)
        return (False, nproc)

    def _fused_mesh(self):
        """(mesh or None, batch_scale) of the fused step, or None when
        this configuration keeps the eager executor path."""
        from ..parallel.mesh import Mesh, data_parallel_mesh, make_mesh

        kv_type = self._kvstore.type if self._kvstore else ""
        nproc = _dist_bootstrap.process_count()
        if nproc > 1:
            # the data plane across worker processes: a synchronous
            # store's; dist_async's server applies each push on arrival
            if ("tpu" not in kv_type and "dist" not in kv_type) \
                    or "async" in kv_type or len(self._context) > 1:
                return None
            use_mesh, scale = self._multiproc_mesh_plan()
            if self._mesh_shape and not use_mesh:
                self.logger.warning(
                    "mesh_shape %s unusable across %d processes (it must "
                    "cover every process, one entry a process, with a "
                    "'data' axis divisible by the process count when "
                    "present); using a 1-D data mesh", self._mesh_shape,
                    nproc)
            mesh = make_mesh(self._mesh_shape) if use_mesh \
                else data_parallel_mesh(nproc)
            return mesh, scale
        if self._mesh_shape:
            try:
                return make_mesh(self._mesh_shape), 1
            except ValueError as exc:
                self.logger.warning(
                    "mesh_shape %s unavailable (%s); training on one "
                    "device", self._mesh_shape, exc)
                return (None, 1)
        if len(self._context) > 1:
            if "tpu" not in kv_type:
                return None    # the executor group with its store
            if len(set(self._context)) != len(self._context):
                return None    # the same context twice: no mesh
            if self._exec_group.batch_size % len(self._context):
                return None
            return Mesh(self._context, ("data",)), 1
        return (None, 1)

    def _collect_shardings(self, mesh):
        """({param: spec}, {input: spec}) from Symbol `__sharding__`
        attributes and the data_shardings argument, checked against the
        mesh's axes: an annotation naming an axis the mesh lacks is
        ignored with a warning (a Symbol may carry annotations for a
        larger mesh than this run's)."""
        if mesh is None:
            return {}, {}
        from ..parallel.mesh import parse_partition_spec

        def valid(spec, name):
            used = [a for dim in spec for a in
                    (dim if isinstance(dim, tuple) else (dim,))
                    if a is not None]
            missing = [a for a in used if a not in mesh.axis_names]
            if missing:
                self.logger.warning(
                    "sharding for %r uses mesh axes %s not in mesh %s; "
                    "ignoring the annotation", name, missing,
                    dict(mesh.shape))
                return None
            return spec

        attrs = self._symbol.attr_dict()
        param_specs, data_specs = {}, {}
        for name in self._param_names:
            s = attrs.get(name, {}).get("__sharding__")
            if s is not None:
                spec = valid(parse_partition_spec(s), name)
                if spec is not None:
                    param_specs[name] = spec
        for name in self._data_names + self._label_names:
            s = self._data_shardings.get(
                name, attrs.get(name, {}).get("__sharding__"))
            if s is not None:
                spec = valid(parse_partition_spec(s), name)
                if spec is not None:
                    data_specs[name] = spec
        return param_specs, data_specs

    def _build_fused_step(self, carry_from=None):
        """Build the fused train step when the configuration supports
        it; otherwise leave the eager executor path. With a mesh in one
        process the step's executor is bound at the global batch; across
        processes at this worker's slice of it."""
        from ..parallel.dp_step import FusedTrainStep, supports_fused
        from ..parallel.mesh import NamedSharding, check_mesh

        self._fused_step = None
        self._fused_stale = False
        if (self._state_names or self.inputs_need_grad
                or not self.for_training
                or (self._monitor is not None and not getattr(
                    self._monitor, "device", False))):
            return
        if not supports_fused(self._optimizer):
            return
        # the fused step writes its gradients: grad_req 'add' or custom
        # per-parameter requests need the eager executors
        if any(self._exec_group.grad_req.get(n) != "write"
               for n in self._param_names
               if n not in self._fixed_param_names):
            return
        found = self._fused_mesh()
        if found is None:
            return
        mesh, scale = found
        nproc = check_mesh(mesh, "Module's fused train step") \
            if mesh is not None else 1
        param_specs, data_specs = self._collect_shardings(mesh)
        # explicit plan overrides > Symbol attributes > plan rules; an
        # input not pinned elsewhere splits dim 0 over the batch axes
        plan = self._sharding_plan if mesh is not None else None
        if plan is not None:
            plan.adopt_mesh(mesh)
            plan_specs = plan.resolve(
                {n: tuple(self._arg_params[n].shape)
                 for n in self._param_names})
            merged = dict(plan_specs)
            merged.update(param_specs)
            for n in plan.explicit_names & set(plan_specs):
                merged[n] = plan_specs[n]
            param_specs = merged
            for d in (self._data_shapes or []) + (self._label_shapes or []):
                if d.name not in data_specs:
                    data_specs[d.name] = plan.input_spec(
                        d.name, ndim=len(d.shape))
        exe = self._exec_group.execs[0]
        if nproc > 1:
            local = {d.name: NamedSharding(mesh, data_specs[d.name])
                     .local_shape(tuple(d.shape))
                     for d in self._exec_descs() if d.name in data_specs}
            if plan is not None or any(
                    v != tuple(d.shape) for d in self._exec_descs()
                    for v in [local.get(d.name, tuple(d.shape))]):
                exe = self._step_executor(local, plan)
        elif mesh is not None and (len(self._exec_group.execs) > 1
                                   or plan is not None):
            exe = self._step_executor({}, plan)
        self._fused_step = FusedTrainStep(
            exe, self._optimizer, self._param_names, mesh=mesh,
            batch_scale=scale, compute_dtype=self._compute_dtype,
            param_specs=param_specs, data_specs=data_specs, plan=plan,
            logger=self.logger)
        if carry_from is not None:
            # only the optimizer state: params were taken fresh from the
            # executor (callers flush first)
            self._fused_step.load_states(carry_from.states, carry_from._t)
        self._fused_dirty = False
        self._eager_seed_t = 0
        self._opt_state_bifurcated = False

    def _exec_descs(self):
        group = self._exec_group
        return list(group.data_shapes) + list(group.label_shapes or [])

    def _step_executor(self, shapes, plan=None):
        """An executor bound at `shapes` ({input: shape}; the group's
        global shapes for the others) on the contexts' device, holding
        the current parameters: the body of the step over a mesh. The
        plan's digest joins its exec-cache key."""
        group = self._exec_group
        descs = self._exec_descs()
        exe = self._symbol.simple_bind(
            ctx=self._context[0], grad_req=dict(group.grad_req),
            type_dict={d.name: d.dtype for d in descs}, sharding=plan,
            **{d.name: tuple(shapes.get(d.name, d.shape)) for d in descs})
        exe.copy_params_from(self._arg_params, self._aux_params)
        exe.cast_compute(self._compute_dtype, keep=self._label_names)
        return exe

    def _disable_fused(self, reason=None):
        if self._fused_step is None:
            return
        if self._fused_surrendered:
            # a non-owner in fused bucketing: the owner carries the
            # canonical state; drop the step without flushing
            self._fused_step = None
            return
        if reason:
            self.logger.info("disabling fused train step: %s", reason)
        self._flush_fused()
        target = self._eager_updater()
        if self._fused_step._t and target is not None:
            # hand the optimizer state (momentum, Adam's moments) to the
            # eager updater
            try:
                target.set_states(self._fused_step.get_states())
            except Exception as exc:
                self.logger.warning(
                    "could not transfer fused optimizer state to the "
                    "eager updater: %s", exc)
        self._fused_step = None

    def _flush_fused(self):
        """Write the step's params/auxs back into the master dicts and
        the executor's arrays (copies: the step's tensors advance in
        place)."""
        if self._fused_step is None or not self._fused_dirty:
            return
        if self._fused_surrendered:
            return  # the owner holds the real state
        params, auxs = self._fused_step.snapshot()
        for n, v in params.items():
            self._arg_params[n]._set_data(v)
        for n, v in auxs.items():
            self._aux_params[n]._set_data(v)
        self._exec_group.set_params(self._arg_params, self._aux_params)
        self._fused_dirty = False

    def _stage_for_fused(self, data_batch):
        """The batch as the fused step's {name: tensor} input, or None
        when it does not fit the step's inputs."""
        def val(arr):
            return arr._data if isinstance(arr, nd.NDArray) \
                else torch.as_tensor(np.asarray(arr))

        try:
            vals = {}
            for desc, arr in zip(self._data_shapes, data_batch.data):
                vals[desc.name] = val(arr)
            if self._label_shapes and data_batch.label:
                for desc, arr in zip(self._label_shapes, data_batch.label):
                    vals[desc.name] = val(arr)
        except Exception:
            return None
        if set(vals) != set(self._fused_step._data_names):
            return None
        fs = self._fused_step
        if fs._mesh is not None:
            # a batch the data axis does not divide runs eagerly
            d = fs._mesh.shape.get(fs._data_axis, 1)
            scale = fs._batch_scale
            if any(v.ndim == 0 or (v.shape[0] * scale) % d
                   for v in vals.values()):
                return None
        return vals

    def _refresh_fused_state(self):
        """Reload the fused step when params (and maybe optimizer state)
        changed outside it."""
        if not self._fused_stale:
            return
        if self._params_dirty and not self._fused_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        self._fused_step.load_params(self._arg_params, self._aux_params)
        if self._opt_state_bifurcated:
            # fold the eager updater's optimizer state back so momentum
            # advanced by eager steps carries on
            target = self._eager_updater()
            if target is not None and target.states:
                try:
                    self._fused_step.set_states(target.get_states())
                except Exception as exc:
                    self.logger.warning(
                        "could not fold eager optimizer state into the "
                        "fused step: %s", exc)
            self._opt_state_bifurcated = False
        self._fused_stale = False

    def _ensure_sentinel(self):
        """Enable the numerics sentinel on the fused step (idempotent).
        Returns the active SentinelSpec, or None when there is no fused
        step for the row to live in."""
        fs = self._fused_step
        if fs is None:
            return None
        if fs._sentinel is not None:
            return fs._sentinel
        from ..numerics.sentinel import SentinelSpec

        spec = SentinelSpec(fs._trainable)
        fs.enable_sentinel(spec)
        return spec

    def train_step_flops(self):
        """Floating-point operations of one fused step (0 without one,
        or before its first run)."""
        return self._fused_step.flops() if self._fused_step else 0.0

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        if getattr(mon, "device", False):
            # device-mode monitor: its stats come from the sentinel row
            # inside the fused step, which stays
            install_module = getattr(mon, "install_module", None)
            if install_module is not None:
                install_module(self)
            for exe in self._exec_group.execs:
                mon.install(exe)
            return
        self._disable_fused("monitor installed (eager per-node execution)")
        for exe in self._exec_group.execs:
            mon.install(exe)

    def cast_compute(self, dtype):
        """Train in the float dtype `dtype` (torch.bfloat16, "bfloat16",
        "float16", a numpy dtype; None: back to the arrays' own) over
        float32 master weights: floating parameters, aux states and data
        are cast to it for forward and backward, unsigned integer data
        is promoted to it, the labels and signed integers are never
        cast; gradients come back through the cast in float32, the
        optimizer updates the float32 weights, and aux updates (moving
        statistics) are written back in float32. The weights in use are
        the current ones: a set_params before or after takes effect."""
        self._compute_dtype = dtype
        if self.binded:
            self._apply_compute_dtype()
        if self.optimizer_initialized and self._fused_step is not None:
            old = self._fused_step
            if self._params_dirty:
                self._sync_params_from_devices()
            self._build_fused_step(carry_from=old)

    def _apply_compute_dtype(self):
        for exe in self._exec_group.execs:
            exe.cast_compute(self._compute_dtype, keep=self._label_names)

    def borrow_optimizer(self, shared_module):
        """Share `shared_module`'s optimizer, updater and states. Under
        MXNET_TPU_BUCKET_FUSED this module builds its own fused step and
        adopts the lender's canonical state (`_adopt_fused`)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
        if shared_module._fused_step is None:
            return
        if _utils.getenv("MXNET_TPU_BUCKET_FUSED"):
            self._build_fused_step()
            self._adopt_fused(shared_module)
            return
        shared_module._disable_fused(
            "optimizer shared (bucketing); reverting to eager updates")

    def _adopt_fused(self, other):
        """Take over the canonical fused training state (parameter,
        optimizer-state and aux tensors, step count) and the coherence
        flags from `other`, the bucket-switch hand-over. The tensors are
        shared, not copied (FusedTrainStep.adopt)."""
        src, dst = other._fused_step, self._fused_step
        if src is None or dst is None or src is dst:
            return
        dst.adopt(src)
        self._fused_dirty = other._fused_dirty
        self._params_dirty = other._params_dirty
        self._fused_stale = other._fused_stale
        self._opt_state_bifurcated = other._opt_state_bifurcated
        self._eager_seed_t = other._eager_seed_t
        self._fused_surrendered = False
        # bulk operations over every bucket must not flush the previous
        # owner's view of the state, nor hand it to an eager updater
        other._fused_surrendered = True
        other._opt_state_bifurcated = False

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes; the parameter and gradient
        arrays (their shapes unchanged) are shared with the old bind."""
        assert self.binded
        self._data_shapes = self._as_descs(data_shapes)
        self._label_shapes = self._as_descs(label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # ------------------------------------------------------ computation
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        if (self._fused_step is not None and is_train
                and (self._monitor is None or getattr(
                    self._monitor, "device", False))):
            vals = self._stage_for_fused(data_batch)
            if vals is not None:
                self._refresh_fused_state()
                self._staged_batch = data_batch
                self._staged_vals = vals
                self._staged_outputs = None
                self._staged_backward = False
                return
        self._staged_batch = None
        self._staged_vals = None
        self._staged_outputs = None
        self._staged_backward = False
        self._flush_fused()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if self._staged_vals is not None:
            if out_grads is None:
                # gradients were asked for: if the batch materializes
                # eagerly later (get_outputs before update), the eager
                # backward runs too
                self._staged_backward = True
                return
            # explicit head gradients: the fused step cannot take them
            self._materialize_staged(run_backward=False)
        self._flush_fused()
        self._exec_group.backward(out_grads=out_grads)

    def _materialize_staged(self, run_backward=None):
        """Replay the staged batch through the executor (and its
        backward when one was asked for)."""
        if run_backward is None:
            run_backward = self._staged_backward
        batch = self._staged_batch
        self._staged_batch = None
        self._staged_vals = None
        self._staged_backward = False
        self._flush_fused()
        self._exec_group.forward(batch, True)
        if run_backward:
            self._exec_group.backward()

    def update(self):
        """One optimizer step over every parameter with a gradient: the
        staged batch's whole fused step, or the eager update."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        if self._staged_vals is not None:
            outs = self._fused_step.step(self._staged_vals)
            self._staged_outputs = [nd.NDArray(o, ctx=self._context[0])
                                    for o in outs]
            self._staged_whole = False
            self._staged_batch = None
            self._staged_vals = None
            self._fused_dirty = True
            return
        if self._fused_step is not None and self._fused_step._t and \
                self._fused_step._t != self._eager_seed_t:
            # an eager update while the fused step holds newer optimizer
            # state: seed the eager updater from it (one lineage)
            try:
                self._eager_updater().set_states(
                    self._fused_step.get_states())
                self._eager_seed_t = self._fused_step._t
            except Exception as exc:
                self.logger.warning(
                    "could not seed eager updater from fused optimizer "
                    "state: %s", exc)
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays, self._updater,
                           len(self._context), kvstore=self._kvstore)
        if self._fused_step is not None:
            # the step reloads params and optimizer state before its
            # next run
            self._fused_stale = True
            self._opt_state_bifurcated = True

    def run_steps(self, data_batch, k, stacked=False):
        """Advance k train steps (forward, backward and update each)
        through the fused step with no host sync in between; the last
        step's outputs are readable through get_outputs().

        stacked=False replays one batch k times; stacked=True takes
        every data/label array with a leading (k,) axis of per-step
        batches. Without a fused step (an eager monitor, another
        grad_req) or for a batch that does not fit its inputs: k eager
        steps, the same semantics."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        if k < 1:
            raise ValueError("run_steps needs k >= 1")

        def eager_fallback():
            for i in range(k):
                if stacked:
                    b = type(data_batch)(
                        data=[d[i] for d in data_batch.data],
                        label=[lb[i] for lb in (data_batch.label or [])])
                else:
                    b = data_batch
                self.forward_backward(b)
                self.update()

        if self._fused_step is None or self._monitor is not None:
            return eager_fallback()
        if stacked:
            per_step = type(data_batch)(
                data=[d[-1] for d in data_batch.data],
                label=[lb[-1] for lb in (data_batch.label or [])])
            if self._stage_for_fused(per_step) is None:
                return eager_fallback()
        vals = self._stage_for_fused(data_batch)
        if vals is None:
            return eager_fallback()
        self._refresh_fused_state()
        self._params_dirty = True
        outs = self._fused_step.run_steps(vals, k, stacked=stacked)
        self._staged_outputs = [nd.NDArray(o, ctx=self._context[0])
                                for o in outs]
        self._staged_whole = False
        self._staged_batch = None
        self._staged_vals = None
        self._fused_dirty = True

    def _whole_staged(self):
        """Across processes with inputs split off the data axis, the
        fused step's outputs are this process's slice: gather them
        whole once (a collective: every process reads them)."""
        fs = self._fused_step
        if self._staged_outputs is not None and fs is not None \
                and fs.splits_inputs and not getattr(
                    self, "_staged_whole", False):
            outs = fs.whole_outputs([o._data for o in self._staged_outputs])
            self._staged_outputs = [nd.NDArray(o, ctx=self._context[0])
                                    for o in outs]
            self._staged_whole = True

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._staged_outputs is not None:
            self._whole_staged()
            outs = self._staged_outputs
            return outs if merge_multi_context else [[o] for o in outs]
        if self._staged_batch is not None:
            # forward staged, update not run: the eager forward of this
            # batch (params are current), and the eager path for the
            # rest of its lifecycle
            self._materialize_staged()
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def _step_fence(self):
        """What fit's dispatch-ahead window waits on for the step just
        dispatched: a CUDA event recorded after it on the card, the last
        output on the CPU (complete already), None with nothing run."""
        if self._context[0].torch_device().type == "cuda":
            event = torch.cuda.Event()
            event.record()
            return event
        if self._staged_outputs:
            return self._staged_outputs[0]._data
        outs = self._exec_group.execs[0].outputs \
            if self._exec_group is not None else None
        return outs[0]._data if outs else None

    def sync(self):
        """Block until the work queued on the parameters' device is
        done (NDArray.wait_to_read on the parameters)."""
        if self._fused_step is not None:
            self._fused_step.sync()
        elif self._exec_group is not None and self._exec_group.param_arrays:
            for arr in self._exec_group.param_arrays[0]:
                arr.wait_to_read()

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._staged_outputs is not None:
            self._whole_staged()
            _metric.update_auto(eval_metric, labels, self._staged_outputs)
            return
        if self._staged_batch is not None:
            # the metric of this batch, not of stale executor outputs
            self._materialize_staged()
        self._exec_group.update_metric(eval_metric, labels)
