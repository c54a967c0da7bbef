"""PipelineModule: GPipe-style pipeline parallelism through the Module
user API (mxnet_tpu/module/pipeline_module.py), both tiers:

  - HOMOGENEOUS (one stage Symbol): S parameter sets for the same
    symbol, stage-major `(S, ...)` leaves over a 'pipe' mesh axis, run
    by `parallel.pipeline.pipeline_apply`;
  - HETEROGENEOUS (a list of stage Symbols): arbitrary per-stage graphs
    (shape changes at boundaries, aux state such as BatchNorm's moving
    statistics, several boundary tensors named `<data>`, `<data>1`, ...)
    over flat float32 per-stage buckets, `params["pipeline_flat"]` of
    shape (S, Lmax) and an (S, Amax) aux bucket, run by
    `pipeline_apply_hetero`.

Forward, backward through the whole pipeline and the optimizer's
`apply_dense` over each bucket make one step (`forward_backward`;
`update()` is a no-op). The loss is fixed at construction: 'l2',
'softmax_ce' (integer class labels against last-dim logits) or a
callable torch `loss(out, label) -> scalar`. The hetero tier's float32
master buckets cast bfloat16/float16 parameters at use; per-name
lr_mult/wd_mult become per-element vectors over the bucket (keys
'stage{s}/{name}', then '{name}', symbol attributes below both);
`tied_params=[("stage0/w", "stageN/w")]` sums the tied segments'
gradients into both copies each step, so they stay bit-identical.
`forward(is_train=False)` is inference: parameters, optimizer state and
`_t` are left alone.

The random keys are the JAX package's, on purpose: the homogeneous tier
hands every stage and microbatch the step's one key, fold_in(key, t);
the hetero tier folds in the stage and then the microbatch.

Where the stages live (parallel/pipeline.py):

- in one process the mesh is `make_mesh({"pipe": S})` and is one
  device's global program: every stage's parameters are whole on the
  module's device, and each leaf's `.sharding` is the JAX package's
  (a NamedSharding over the pipe axis whose `device_set` has S entries).
  On one CUDA card that mesh is refused, as the JAX package refuses
  a 4-stage mesh on one chip;
- across processes (tools/launch.py) the mesh is one entry a process
  along 'pipe', and each process holds a contiguous block of S/p stages:
  only its rows of the stage-major leaves, of `pipeline_flat`, of the
  aux bucket and of the optimizer state are stored there, and the
  heterogeneous tier binds executors for its own stages alone (the
  others' shapes come from shape inference). Every process
  feeds the same batch ('pipe' splits no input); the outputs and the
  loss reach every process; the parameters start from rank 0's values;
  the tied segments' gradients are summed over the pipe group when the
  two copies sit on different processes; `get_params` gathers the
  blocks (a collective: every process calls it).

`init_params(arg_params=...)` takes the JAX package's parameters as they
are: its stage-major leaves by name, or `pipeline_flat` whole (with
`aux_params={"pipeline_flat": its aux bucket}`), or 'stage{s}/{name}'
tensors, each a numpy-convertible array or NDArray, so both packages can
start from one state.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .base_module import BaseModule
from .. import _dist_bootstrap
from .. import context as ctx
from .. import ndarray as nd
from .. import optimizer as opt
from .. import random as _random
from ..base import MXNetError
from ..initializer import InitDesc, Uniform

_FLAT = "pipeline_flat"


def _host(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def _dtype_name(d):
    if isinstance(d, torch.dtype):
        return str(d).replace("torch.", "")
    return str(np.dtype(d)) if not isinstance(d, str) else d


def _torch_dtype(name):
    from ..ops.shape_infer import torch_dtype

    return torch_dtype(name)


def _stage_signature(sym, shapes, types):
    """(output shapes, output dtypes, {argument: (shape, dtype)}, {aux
    state: (shape, dtype)}) of a stage bound at its input shapes and
    dtypes, all from shape and dtype inference; the outputs' dtypes as
    the stage's ops compute them (a run of the ops on meta tensors,
    every argument at its bound dtype: a bfloat16 activation against a
    float32 weight comes out float32)."""
    from ..symbol import _graph_infer, _key

    arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**shapes)
    arg_types, _, aux_types = sym.infer_type(**types)
    args, auxs = sym.list_arguments(), sym.list_auxiliary_states()
    names = args + auxs
    _, dts = _graph_infer(
        sym._outputs, dict(zip(names, arg_shapes + aux_shapes)),
        dict(zip(names, arg_types + aux_types)))
    return ([tuple(o) for o in out_shapes],
            [dts[_key(h)] for h in sym._outputs],
            {n: (tuple(sh), _dtype_name(t))
             for n, sh, t in zip(args, arg_shapes, arg_types)},
            {n: (tuple(sh), _dtype_name(t))
             for n, sh, t in zip(auxs, aux_shapes, aux_types)})


def _segments(named):
    """[(name, offset, size, shape, dtype)] of {name: (shape, dtype)}
    laid end to end in a flat bucket."""
    segs, off = [], 0
    for n, (shp, dt) in named.items():
        sz = int(np.prod(shp)) if shp else 1
        segs.append((n, off, sz, shp, dt))
        off += sz
    return segs


class PipelineModule(BaseModule):
    def __init__(self, stage_symbol, num_stages=None, num_microbatches=1,
                 data_names=("data",), label_names=("label",),
                 context=None, loss="l2", tied_params=None,
                 logger=logging):
        super().__init__(logger=logger)
        self._tied_pairs = [tuple(p) for p in (tied_params or [])]
        if self._tied_pairs and not isinstance(
                stage_symbol, (list, tuple)):
            raise MXNetError(
                "tied_params needs the heterogeneous tier (a list of "
                "stage symbols); in a single graph share the Variable")
        if len(data_names) != 1 or len(label_names) != 1:
            raise MXNetError(
                "PipelineModule takes exactly one data and one label")
        if isinstance(stage_symbol, (list, tuple)):
            self._hetero = True
            self._stage_syms = list(stage_symbol)
            if num_stages is not None and \
                    int(num_stages) != len(self._stage_syms):
                raise MXNetError(
                    f"num_stages {num_stages} != len(stage list) "
                    f"{len(self._stage_syms)}")
            self._num_stages = len(self._stage_syms)
            self._symbol = self._stage_syms[-1]
        else:
            self._hetero = False
            if num_stages is None:
                raise MXNetError("num_stages required for a single "
                                 "stage symbol")
            self._symbol = stage_symbol
            self._num_stages = int(num_stages)
        self._num_micro = int(num_microbatches)
        self._data_names = list(data_names)
        self._label_names = list(label_names)
        self._context = context if context is not None \
            else ctx.current_context()
        if isinstance(self._context, (list, tuple)):
            self._context = self._context[0]
        if not callable(loss) and loss not in ("l2", "softmax_ce"):
            raise MXNetError(
                f"unknown loss {loss!r}: expected 'l2', 'softmax_ce' "
                "or a callable torch loss(out, label) -> scalar")
        self._loss = loss
        if not self._hetero and self._symbol.list_auxiliary_states():
            raise MXNetError(
                "aux states (BatchNorm moving stats) need the "
                "heterogeneous tier: pass a LIST of stage symbols")
        if not self._hetero:
            self._param_names = [
                n for n in self._symbol.list_arguments()
                if n not in self._data_names
            ]
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.for_training = True
        self._outputs = None
        self._loss_val = None

    # ---------------------------------------------------------- binding
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        from ..parallel.mesh import make_mesh, stage_blocks

        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        desc = data_shapes[0]
        if hasattr(desc, "name"):
            name, shape = desc.name, desc.shape
            dtype = getattr(desc, "dtype", None) or "float32"
        else:
            name, shape = desc[0], desc[1]
            dtype = "float32"
        if name != self._data_names[0]:
            raise MXNetError(f"expected data name {self._data_names[0]}")
        batch = shape[0]
        if batch % self._num_micro != 0:
            raise MXNetError(
                f"batch {batch} not divisible into {self._num_micro} "
                "microbatches")
        self._batch_shape = tuple(shape)
        self._data_dtype = _dtype_name(dtype)
        self._mb_shape = (batch // self._num_micro,) + tuple(shape[1:])
        self._nproc = _dist_bootstrap.process_count()
        # one process: S entries (one device's global program); across
        # processes one entry a process, each holding a block of stages
        self._mesh = make_mesh({"pipe": self._num_stages
                                if self._nproc == 1 else self._nproc})
        blocks = stage_blocks(self._mesh, self._num_stages)
        self._index = self._mesh.axis_index("pipe") if len(blocks) > 1 \
            else 0
        self._lo, self._hi = blocks[self._index]
        self._device = self._context.torch_device()
        if self._hetero:
            self._bind_hetero()
        else:
            self._bind_homogeneous()
        self._rng = _random._seed_key(0)
        self.binded = True
        self.for_training = for_training
        self._t = 0

    def _bind_homogeneous(self):
        # one executor at microbatch shape supplies the stage function
        # and the per-stage parameter shapes
        self._stage_exec = self._symbol.simple_bind(
            ctx=self._context, grad_req="null",
            **{self._data_names[0]: self._mb_shape})
        _, out_shapes, _ = self._symbol.infer_shape(
            **{self._data_names[0]: self._mb_shape})
        out_shapes = [tuple(o) for o in out_shapes]
        if out_shapes[0] != self._mb_shape:
            raise MXNetError(
                f"stage symbol must preserve shape: {self._mb_shape} "
                f"-> {out_shapes[0]} (shape-changing stages need the "
                "heterogeneous tier: pass a LIST of stage symbols)")
        self._param_shapes = {
            n: tuple(self._stage_exec.arg_dict[n].shape)
            for n in self._param_names
        }
        self._out_shape = out_shapes[0]

    def _stage_input_names(self, sym):
        """The symbol's boundary-input arguments, ordered: the module's
        data name first, then `<data>1`, `<data>2`, ... — stage s+1's
        i-th input receives stage s's i-th output."""
        dname = self._data_names[0]
        found = {}
        for n in sym.list_arguments():
            if n == dname:
                idx = 0
            elif n.startswith(dname) and n[len(dname):].isdigit():
                idx = int(n[len(dname):])
            else:
                continue
            if idx in found:
                raise MXNetError(
                    f"boundary inputs {found[idx]!r} and {n!r} both "
                    f"map to position {idx}; name them {dname!r}, "
                    f"{dname}1, {dname}2, ... without duplicates")
            found[idx] = n
        if 0 not in found:
            raise MXNetError(
                f"stage has no input named {dname!r}; boundary inputs "
                f"must be named {dname!r}, {dname!r}+'1', ...")
        idxs = sorted(found)
        if idxs != list(range(len(idxs))):
            raise MXNetError(
                f"stage boundary inputs must be consecutively "
                f"numbered; got {[found[i] for i in idxs]}")
        return [found[i] for i in idxs]

    _FLOATY = ("float16", "bfloat16", "float32")

    def _bind_hetero(self):
        """Chain-infer the stage symbols at microbatch shape (stage s's
        inputs are stage s-1's outputs, any arity), lay out the flat
        per-stage float32 parameter and aux buckets, and bind an
        executor for this process's stages [lo, hi) alone (the others'
        entries are None: another process runs them)."""
        self._stage_execs = []
        self._stage_in_names = []
        self._in_shapes, self._in_dtypes = [], []
        self._out_shapes_h, self._out_dtypes = [], []
        self._param_segs, self._aux_segs = [], []
        in_shapes = [self._mb_shape]
        in_dtypes = [self._data_dtype]
        for s, sym in enumerate(self._stage_syms):
            in_names = self._stage_input_names(sym)
            if s == 0 and len(in_names) != 1:
                raise MXNetError(
                    "stage 0 takes exactly the module data input")
            if len(in_names) != len(in_shapes):
                raise MXNetError(
                    f"stage {s} declares {len(in_names)} boundary "
                    f"inputs but stage {s - 1} produces "
                    f"{len(in_shapes)} outputs")
            shapes = dict(zip(in_names, in_shapes))
            types = dict(zip(in_names, in_dtypes))
            out_shapes, out_types, args, auxs = _stage_signature(
                sym, shapes, types)
            params = {n: v for n, v in args.items()
                      if n not in set(in_names)}
            for n, (_shp, d) in {**params, **auxs}.items():
                if d not in self._FLOATY:
                    raise MXNetError(
                        f"stage {s} param/aux {n!r} is {d}; pipeline "
                        "params/auxs must be float (f32 master bucket "
                        "with bf16/f16 cast-at-use)")
            self._param_segs.append(_segments(params))
            self._aux_segs.append(_segments(auxs))
            self._stage_execs.append(
                sym.simple_bind(ctx=self._context, grad_req="null",
                                type_dict=types, **shapes)
                if self._lo <= s < self._hi else None)
            self._stage_in_names.append(in_names)
            self._in_shapes.append([tuple(sh) for sh in in_shapes])
            self._in_dtypes.append([_dtype_name(d) for d in in_dtypes])
            self._out_shapes_h.append([tuple(o) for o in out_shapes])
            self._out_dtypes.append([_dtype_name(d) for d in out_types])
            in_shapes = self._out_shapes_h[-1]
            in_dtypes = self._out_dtypes[-1]
        if len(self._out_shapes_h[-1]) != 1:
            raise MXNetError(
                "the last pipeline stage must have exactly one output")
        self._out_shape = self._out_shapes_h[-1][0]
        # boundary activations round-trip through float32 (the JAX
        # package's ring buffer): integer, bool or float64 boundaries
        # would be corrupted, so they are refused (stage-0 integer
        # INPUTS never cross a boundary)
        for s, dts in enumerate(self._out_dtypes[:-1]):
            for d in dts:
                if d not in self._FLOATY:
                    raise MXNetError(
                        f"stage {s} output dtype {d} cannot cross the "
                        "pipeline boundary: inter-stage activations "
                        "round-trip through a float32 ring buffer, so "
                        "boundary dtypes must be "
                        "float16/bfloat16/float32")
        self._lmax = max(sum(sz for (_, _, sz, _, _) in segs)
                         for segs in self._param_segs)
        self._amax = max(sum(sz for (_, _, sz, _, _) in segs)
                         for segs in self._aux_segs)
        self._param_names = [
            f"stage{s}/{n}"
            for s, segs in enumerate(self._param_segs)
            for (n, _, _, _, _) in segs
        ]
        self._resolve_ties()

    def _resolve_ties(self):
        """Resolve tied_params pairs into bucket segments: the step sums
        the two copies' gradients and writes the sum into both, so with
        equal init and equal multipliers they stay bit-identical."""
        self._ties = []
        if not self._tied_pairs:
            return
        segmap = {}
        for s, segs in enumerate(self._param_segs):
            for (n, off, sz, shp, dt) in segs:
                segmap[f"stage{s}/{n}"] = (s, off, sz, shp, dt)
        seen = set()
        for a, b in self._tied_pairs:
            if a not in segmap or b not in segmap:
                missing = a if a not in segmap else b
                raise MXNetError(
                    f"tied_params: {missing!r} is not a pipeline "
                    f"parameter (known: {sorted(segmap)})")
            if a == b:
                raise MXNetError(
                    f"tied_params: {a!r} tied to itself")
            # disjoint pairs: chained ties would make the sums unequal
            # across copies
            for name in (a, b):
                if name in seen:
                    raise MXNetError(
                        f"tied_params: {name!r} appears in more than "
                        "one pair; ties must be disjoint pairs (a "
                        "3-way tie is not supported)")
                seen.add(name)
            sa, offa, sza, shpa, _ = segmap[a]
            sb, offb, szb, shpb, _ = segmap[b]
            if shpa != shpb:
                raise MXNetError(
                    f"tied_params: {a!r} {shpa} and {b!r} {shpb} "
                    "must have identical shapes")
            self._ties.append((sa, offa, sb, offb, sza, a, b))

    # ------------------------------------------------------- parameters
    def _place(self, host):
        """This process's rows of a stage-major host array, on the
        module's device, with the JAX package's `.sharding`."""
        from ..parallel.mesh import NamedSharding, PartitionSpec

        t = torch.as_tensor(np.ascontiguousarray(
            host[self._lo:self._hi])).to(self._device)
        t.sharding = NamedSharding(self._mesh, PartitionSpec("pipe"))
        return t

    def _bcast(self, arrays):
        """Rank 0's host values on every process (one weight lineage)."""
        if self._nproc == 1:
            return arrays
        from ..parallel import collective

        ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        collective.broadcast_coalesced_(ts, 0)
        return [t.numpy() for t in ts]

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("bind before init_params")
        if self._hetero:
            self._init_params_hetero(initializer, arg_params,
                                     aux_params, allow_missing)
            return
        attrs = self._symbol.attr_dict()
        rs = np.random.RandomState(0)
        stacked = {}
        for pname, pshape in self._param_shapes.items():
            if arg_params and pname in arg_params:
                v = _host(arg_params[pname])
                if v.shape == (self._num_stages,) + pshape:
                    stacked[pname] = v.astype(np.float32)
                    continue
                stages = [v] * self._num_stages
            elif initializer is not None:
                stages = []
                for s in range(self._num_stages):
                    a = nd.zeros(pshape, ctx=ctx.cpu())
                    initializer(InitDesc(pname, attrs.get(pname)), a)
                    stages.append(a.asnumpy())
            elif allow_missing:
                stages = [rs.uniform(-0.07, 0.07, pshape)
                          .astype("float32")] * self._num_stages
            else:
                raise MXNetError(f"no value for parameter {pname}")
            stacked[pname] = np.stack(stages)
        names = list(stacked)
        vals = self._bcast([stacked[n] for n in names])
        self.params = {n: self._place(v) for n, v in zip(names, vals)}
        self.params_initialized = True

    def _init_params_hetero(self, initializer, arg_params, aux_params,
                            allow_missing):
        rs = np.random.RandomState(0)
        flat = np.zeros((self._num_stages, self._lmax), np.float32)
        whole = arg_params.get(_FLAT) if arg_params else None
        if whole is not None:
            flat[:] = _host(whole)
        else:
            for s, segs in enumerate(self._param_segs):
                attrs = self._stage_syms[s].attr_dict()
                for (n, off, sz, shp, _dt) in segs:
                    key = f"stage{s}/{n}"
                    if arg_params and key in arg_params:
                        v = _host(arg_params[key])
                    elif arg_params and n in arg_params and \
                            tuple(arg_params[n].shape) == shp:
                        v = _host(arg_params[n])
                    elif initializer is not None:
                        a = nd.zeros(shp, ctx=ctx.cpu())
                        initializer(InitDesc(n, attrs.get(n)), a)
                        v = a.asnumpy()
                    elif allow_missing:
                        v = rs.uniform(-0.07, 0.07, shp).astype("float32")
                    else:
                        raise MXNetError(f"no value for parameter {key}")
                    flat[s, off:off + sz] = np.ravel(
                        np.asarray(v, dtype=np.float32))
            # tied copies start from ONE value (the first name's)
            for (sa, offa, sb, offb, sz, _a, _b) in self._ties:
                flat[sb, offb:offb + sz] = flat[sa, offa:offa + sz]
        auxf = np.zeros((self._num_stages, self._amax), np.float32)
        whole = aux_params.get(_FLAT) if aux_params else None
        if whole is not None:
            auxf[:] = _host(whole)
        else:
            init = initializer if initializer is not None \
                else Uniform(0.07)
            for s, segs in enumerate(self._aux_segs):
                attrs = self._stage_syms[s].attr_dict()
                for (n, off, sz, shp, _dt) in segs:
                    key = f"stage{s}/{n}"
                    if aux_params and key in aux_params:
                        v = _host(aux_params[key])
                    else:
                        # the initializer's name dispatch gives the aux
                        # defaults (moving_mean zeros, moving_var ones)
                        a = nd.zeros(shp, ctx=ctx.cpu())
                        init(InitDesc(n, attrs.get(n)), a)
                        v = a.asnumpy()
                    auxf[s, off:off + sz] = np.ravel(
                        np.asarray(v, dtype=np.float32))
        flat, auxf = self._bcast([flat, auxf])
        self.params = {_FLAT: self._place(flat)}
        self._flat_auxs = self._place(auxf)
        self.params_initialized = True

    def _gather(self, t):
        """The whole stage-major value of this process's rows (a
        collective across processes)."""
        if self._nproc == 1:
            return t.detach().cpu().numpy()
        from ..parallel import collective

        return collective.gather_axes(t.detach(), self._mesh, ("pipe",),
                                      0).cpu().numpy()

    def get_params(self):
        """COLLECTIVE across processes (each holds a block of stages):
        every process must call it."""
        if not self._hetero:
            host = {k: nd.array(self._gather(v), ctx=ctx.cpu())
                    for k, v in self.params.items()}
            return host, {}
        flat = self._gather(self.params[_FLAT])
        auxf = self._gather(self._flat_auxs)
        args, auxs = {}, {}
        for s in range(self._num_stages):
            for (n, off, sz, shp, _dt) in self._param_segs[s]:
                args[f"stage{s}/{n}"] = nd.array(
                    flat[s, off:off + sz].reshape(shp), ctx=ctx.cpu())
            for (n, off, sz, shp, _dt) in self._aux_segs[s]:
                auxs[f"stage{s}/{n}"] = nd.array(
                    auxf[s, off:off + sz].reshape(shp), ctx=ctx.cpu())
        return args, auxs

    # -------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore=None, optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        from ..parallel.dp_step import _as_tensor, _map_tree, \
            supports_fused

        if isinstance(optimizer, str):
            optimizer = opt.create(optimizer, **dict(optimizer_params))
        if not supports_fused(optimizer):
            raise MXNetError(
                "PipelineModule needs an optimizer with a traced "
                f"apply_dense ({type(optimizer).__name__} lacks one)")
        self._optimizer = optimizer
        self.states = {
            n: _map_tree(_as_tensor, optimizer.create_state(
                i, nd.NDArray(v.detach().clone())))
            for i, (n, v) in enumerate(self.params.items())}
        self._lr_vec = self._wd_vec = None
        if self._hetero:
            self._build_mult_vectors(optimizer)
        self.optimizer_initialized = True

    def _build_mult_vectors(self, optimizer):
        """Per-element lr/wd multiplier vectors over this process's rows
        of the bucket. Lookup: symbol attributes, then 'stage{s}/{name}',
        then bare '{name}'."""
        attr_dicts = [sym.attr_dict() for sym in self._stage_syms]

        def mults(s, n):
            a = attr_dicts[s].get(n, {})
            lm = float(a.get("__lr_mult__", 1.0))
            wm = float(a.get("__wd_mult__", 1.0))
            for key in (f"stage{s}/{n}", n):
                if key in optimizer.lr_mult:
                    lm = optimizer.lr_mult[key]
                    break
            for key in (f"stage{s}/{n}", n):
                if key in optimizer.wd_mult:
                    wm = optimizer.wd_mult[key]
                    break
            return (lm, wm)

        lrv = np.ones((self._num_stages, self._lmax), np.float32)
        wdv = np.ones((self._num_stages, self._lmax), np.float32)
        tie_mults = {}
        for s, segs in enumerate(self._param_segs):
            for (n, off, sz, _shp, _dt) in segs:
                lm, wm = mults(s, n)
                tie_mults[f"stage{s}/{n}"] = (lm, wm)
                lrv[s, off:off + sz] = lm
                wdv[s, off:off + sz] = wm
        for (a, b) in [(t[5], t[6]) for t in self._ties]:
            if tie_mults.get(a) != tie_mults.get(b):
                raise MXNetError(
                    f"tied parameters {a!r}/{b!r} must share "
                    "lr_mult/wd_mult (else the copies diverge)")
        self._lr_vec = self._place(lrv) if (lrv != 1.0).any() else None
        self._wd_vec = self._place(wdv) if (wdv != 1.0).any() else None

    # ------------------------------------------------------ computation
    def _loss_of(self, out, label):
        if callable(self._loss):
            return self._loss(out, label)
        if self._loss == "softmax_ce":
            logp = torch.log_softmax(out, dim=-1)
            lab = label.to(torch.int64)
            return -logp.gather(-1, lab[..., None])[..., 0].mean()
        return torch.mean(torch.square(out - label))

    def _hetero_stage_fns(self, rng, is_train):
        """The per-stage bodies pipeline_apply_hetero runs: unflatten the
        stage's bucket, run its graph, re-flatten its aux."""
        fns = []
        for s, ex in enumerate(self._stage_execs):
            def make(s=s, ex=ex):
                segs = self._param_segs[s]
                asegs = self._aux_segs[s]
                in_names = self._stage_in_names[s]

                def fn(pvec, avec, xs, mb_idx):
                    if ex is None:
                        raise MXNetError(
                            f"stage {s} runs in another process")
                    # f32 master bucket -> each param's bound dtype
                    args = {
                        n: pvec[off:off + sz].reshape(shp).to(
                            _torch_dtype(dt))
                        for (n, off, sz, shp, dt) in segs
                    }
                    auxs = {
                        n: avec[off:off + sz].reshape(shp).to(
                            _torch_dtype(dt))
                        for (n, off, sz, shp, dt) in asegs
                    }
                    r = _random.fold_in(_random.fold_in(rng, s), mb_idx)
                    args.update(zip(in_names, xs))
                    outs, aux_upd = ex._run_graph(args, is_train,
                                                  aux_vals=auxs, rng=r)
                    a2 = avec
                    if any(n in aux_upd for (n, *_r) in asegs):
                        a2 = avec.detach().clone()
                        for (n, off, sz, shp, dt) in asegs:
                            if n in aux_upd:
                                a2[off:off + sz] = aux_upd[n].detach() \
                                    .reshape(-1).to(torch.float32)
                    return tuple(outs), a2

                fn.in_shapes = self._in_shapes[s]
                fn.in_dtypes = self._in_dtypes[s]
                fn.out_shapes = self._out_shapes_h[s]
                fn.out_dtypes = self._out_dtypes[s]
                return fn

            fns.append(make())
        return fns

    def _run(self, params, data, rng, is_train):
        """(outputs (batch, ...), new aux bucket rows or None) of the
        pipeline on `data` with the parameter tensors `params`."""
        from ..parallel.pipeline import (pipeline_apply,
                                         pipeline_apply_hetero)

        mbs = data.reshape((self._num_micro,) + self._mb_shape)
        if self._hetero:
            out, new_auxs = pipeline_apply_hetero(
                self._hetero_stage_fns(rng, is_train), params[_FLAT],
                self._flat_auxs, mbs, self._mesh, "pipe")
            return out.reshape((self._batch_shape[0],)
                               + tuple(self._out_shape[1:])), new_auxs
        run = self._stage_exec._run_graph
        dname = self._data_names[0]

        def stage_fn(local_params, x, stage_idx):
            del stage_idx
            outs, _ = run({**local_params, dname: x}, is_train,
                          aux_vals={}, rng=rng)
            return outs[0]

        out = pipeline_apply(stage_fn, params, mbs, self._mesh, "pipe")
        return out.reshape(tuple(data.shape)), None

    def _stage_data(self, arr):
        """A batch input on the module's device; across processes every
        process must feed the same batch ('pipe' splits no input)."""
        v = arr._data if isinstance(arr, nd.NDArray) \
            else torch.as_tensor(np.asarray(arr))
        return v.to(self._device)

    def _tied_grads(self, g):
        """Each tied pair's two segments set to their gradients' sum
        (over the pipe group when the copies sit on different
        processes)."""
        lo, hi = self._lo, self._hi
        parts = []
        for (sa, offa, sb, offb, sz, _a, _b) in self._ties:
            for s, off in ((sa, offa), (sb, offb)):
                parts.append(g[s - lo, off:off + sz] if lo <= s < hi
                             else g.new_zeros(sz))
        if self._nproc > 1:
            from ..parallel import collective

            buf = torch.cat(parts)
            collective.all_reduce_axes_(buf, self._mesh, ("pipe",))
            parts = list(buf.split([p.numel() for p in parts]))
        g = g.clone()
        for i, (sa, offa, sb, offb, sz, _a, _b) in enumerate(self._ties):
            tied = parts[2 * i] + parts[2 * i + 1]
            for s, off in ((sa, offa), (sb, offb)):
                if lo <= s < hi:
                    g[s - lo, off:off + sz] = tied
        return g

    def forward_backward(self, data_batch):
        from ..parallel.dp_step import _copy_tree

        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._t += 1
        rng = _random.fold_in(self._rng, self._t)
        data = self._stage_data(data_batch.data[0])
        label = self._stage_data(data_batch.label[0])
        o = self._optimizer
        o.num_update += 1
        lr_host = o.lr_scheduler(o.num_update) if o.lr_scheduler else o.lr
        names = list(self.params)
        with torch.enable_grad():
            leaves = {n: self.params[n].detach().requires_grad_(True)
                      for n in names}
            out, new_auxs = self._run(leaves, data, rng, True)
            lval = self._loss_of(out, label)
            grads = dict(zip(names, torch.autograd.grad(
                lval, [leaves[n] for n in names], allow_unused=True)))
        with torch.no_grad():
            grads = {n: (g if g is not None
                         else torch.zeros_like(self.params[n]))
                     for n, g in grads.items()}
            if self._hetero and self._ties:
                grads[_FLAT] = self._tied_grads(grads[_FLAT])
            lr = torch.tensor(lr_host, dtype=torch.float32,
                              device=self._device)
            t = torch.tensor(self._t, dtype=torch.int32,
                             device=self._device)
            for n in names:
                w, g, st = self.params[n], grads[n], self.states[n]
                if n == _FLAT and (self._lr_vec is not None
                                   or self._wd_vec is not None):
                    lr_b = lr if self._lr_vec is None \
                        else lr * self._lr_vec
                    if self._wd_vec is not None and o.wd:
                        with o.temp_wd_mult(_FLAT + "::vec",
                                            self._wd_vec):
                            w2, s2 = o.apply_dense(_FLAT + "::vec", w, g,
                                                   st, lr_b, t)
                    else:
                        w2, s2 = o.apply_dense(n, w, g, st, lr_b, t)
                else:
                    w2, s2 = o.apply_dense(n, w, g, st,
                                           lr * o._lr_mult_for(n), t)
                w.copy_(w2)
                _copy_tree(st, s2)
            if new_auxs is not None:
                self._flat_auxs.copy_(new_auxs)
        self._loss_val = lval.detach()
        self._outputs = [nd.NDArray(out.detach())]

    def update(self):
        pass  # forward_backward already applied the update

    def get_outputs(self, merge_multi_context=True):
        return self._outputs

    @property
    def loss_value(self):
        return float(self._loss_val)

    def forward(self, data_batch, is_train=None):
        """Inference through the pipeline: no backward, no update, no
        label needed (train steps go through forward_backward)."""
        if is_train is None:
            is_train = False
        if is_train:
            self.forward_backward(data_batch)
            return
        assert self.binded and self.params_initialized
        data = self._stage_data(data_batch.data[0])
        with torch.no_grad():
            out, _ = self._run(self.params, data,
                               _random.fold_in(self._rng, 0), False)
        self._outputs = [nd.NDArray(out.detach())]
