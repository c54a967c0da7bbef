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

Not ported: the exec cache and its disk tier (PyTorch runs eagerly, so
there is no traced program to cache), the calibration store, monitor
callbacks, `reshape`, ctx-group placement and sharding.
"""
from __future__ import annotations

import torch

from . import passes as _passes
from . import random as _random
from .base import MXNetError
from .context import as_context
from .ndarray import NDArray
from .symbol import _topo


class Executor:
    """A Symbol bound to devices and arrays, runnable forward/backward."""

    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states):
        self._symbol = symbol
        self._ctx = as_context(ctx)
        self._device = self._ctx.torch_device()
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
        self._build()

    # ----------------------------------------------------------- build
    def _build(self):
        """Pass pipeline, codegen plan (kernels built and checked here on
        the card), and the node plan of the walk."""
        self._opt_symbol = _passes.optimize_for_bind(self._symbol)
        self._codegen_plan = _passes.plan_for(
            self._opt_symbol,
            input_shapes={n: tuple(a.shape)
                          for n, a in {**self.arg_dict,
                                       **self.aux_dict}.items()},
            device=self._device)
        nodes = _topo(self._opt_symbol._outputs)
        cg = self._codegen_plan
        skip = frozenset(id(nodes[i]) for i in cg.skip)
        fused = {id(nodes[i]): (fn, tuple((id(nodes[s]), oi)
                                          for s, oi in ext))
                 for i, (fn, ext) in cg.fused.items()}
        plan = []
        for n in nodes:
            if n.is_variable or id(n) in skip:
                continue
            params = n.op.normalize_params(n.attrs)
            plan.append((n.op, params, n.op.resolved_num_outputs(params),
                         [(id(src), i) for src, i in n.inputs], id(n),
                         fused.get(id(n))))
        self._plan = plan
        self._var_names = {id(n): n.name for n in nodes if n.is_variable}
        self._heads = [(id(n), i) for n, i in self._opt_symbol._outputs]

    # --------------------------------------------------------- running
    def _run_graph(self, arg_vals, is_train):
        env = {}
        aux_set = set(self._aux_names)
        for nid, name in self._var_names.items():
            env[(nid, 0)] = (self.aux_dict[name]._data if name in aux_set
                             else arg_vals[name])
        aux_updates = {}
        for opdef, params, n_out, in_keys, nid, fused in self._plan:
            if fused is not None:
                fn, ext_keys = fused
                env[(nid, 0)] = fn(*[env[k].contiguous() for k in ext_keys])
                continue
            kwargs = dict(params)
            if opdef.needs_rng:
                kwargs["rng"] = _random.generator(self._device)
            if opdef.needs_mode:
                kwargs["is_train"] = is_train
            res = opdef.fn(*[env[k] for k in in_keys], **kwargs)
            if not isinstance(res, tuple):
                res = (res,)
            if not in_keys:  # constant sources are built on the host
                res = tuple(r.to(self._device) for r in res)
            for i in range(n_out):
                env[(nid, i)] = res[i]
            n_aux = len(opdef.aux_names)
            if n_aux and is_train and len(res) > n_out:
                for (src, _), upd in zip(in_keys[-n_aux:], res[n_out:]):
                    aux_updates[self._var_names[src]] = upd
        return [env[k] for k in self._heads], aux_updates

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown forward argument {k!r}")
            self.arg_dict[k][:] = v
        arg_vals = {n: self.arg_dict[n]._data for n in self._arg_names}
        self._train = None
        self._cached_grads = None
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
        self.outputs = [NDArray(o.detach(), ctx=self._ctx) for o in outs]
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
                    else:
                        tgt._data.copy_(g)
                elif req == "add":
                    if g is not None:
                        tgt._data.add_(g)
                else:
                    raise MXNetError(f"unknown grad_req {req!r}")

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
