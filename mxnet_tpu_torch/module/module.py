"""Module: Symbol + one device -> trainable model
(mxnet_tpu/module/module.py).

bind / init_params / set_params / get_params / init_optimizer /
forward / backward / update / update_metric, driven by BaseModule.fit.
The Module keeps master copies of the parameters (`_arg_params`,
`_aux_params`) beside the executor's arrays, as the JAX package does,
and synchronizes them on get_params.

One device only: `kvstore` may be None or 'local' (with one device
MXNet uses no store at all); any other store waits for the KVStore
slice (`model._create_kvstore` decides). Not ported: the fused train
step (one jit of forward, backward and update in the JAX package),
cast_compute, sharding plans, shared modules (BucketingModule).
Checkpoints are `model.save_checkpoint` / `load_checkpoint`.
"""
from __future__ import annotations

import logging

import numpy as np

from .. import context as _context
from .. import metric as _metric
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import _create_kvstore, _update_params
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


class Module(BaseModule):
    """The trainer for one Symbol on one device."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = _context.current_context()
        if isinstance(context, _context.Context):
            context = [context]
        context = [_context.as_context(c) for c in context]
        if len(context) != 1:
            raise MXNetError(
                f"Module runs on one device in this port, got {context}; "
                "data parallelism over several devices waits for the "
                "KVStore of the multi-device slice (ROADMAP.md A.5.2), "
                "whatever the kvstore argument")
        context[0].torch_device()  # raises when the card is missing
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
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

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

    # ------------------------------------------------------- parameters
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return (self._arg_params, self._aux_params)

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
        attrs = self._symbol.attr_dict()

        def fill(table, source):
            for name, arr in table.items():
                given = None if source is None else source.get(name)
                if given is not None:
                    if given is not arr:
                        if isinstance(given, nd.NDArray):
                            given.copyto(arr)
                        else:
                            arr[:] = given
                    continue
                if source is not None and not allow_missing:
                    raise RuntimeError(f"{name} is not presented")
                if initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), arr)

        fill(self._arg_params, arg_params)
        fill(self._aux_params, aux_params)
        self.params_initialized = True
        self._params_dirty = False
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
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # ---------------------------------------------------------- binding
    @staticmethod
    def _as_descs(shapes):
        if not shapes:
            return None
        return [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1])
                for s in shapes]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor for these shapes (building the bind's
        fusion kernels on the card)."""
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module (bucketing) is not ported yet")
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad requires for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = self._as_descs(data_shapes)
        self._label_shapes = self._as_descs(label_shapes)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, None, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad, None, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names)
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
        _create_kvstore(kvstore, len(self._context), self._arg_params)
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._exec_group.param_names))
            settings = dict(optimizer_params or ())
            settings.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name, **settings)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but rescale_grad "
                "is not normalized to 1.0/batch_size (%s vs. %s). Is this "
                "intended?", optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._kvstore = None
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # ------------------------------------------------------ computation
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over every parameter with a gradient."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, self._updater,
                       len(self._context))

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)
