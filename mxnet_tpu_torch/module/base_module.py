"""BaseModule: the training-API contract and the `fit` loop
(mxnet_tpu/module/base_module.py).

`fit` binds, initializes parameters and the optimizer, then runs the
per-batch loop forward_backward -> update -> update_metric -> callbacks,
the loop the JAX package runs when it has no fused train step. On the
card the loop does not wait for the device: the kernels of step N+1 are
queued while step N runs, and the metrics accumulate on the device
until a log interval or the epoch end reads them.

Not ported: steps_per_dispatch (the compiled k-step loop), the numerics
monitor, the dispatch-ahead window, predict/score merging across
contexts beyond one device, save/load of parameters.
"""
from __future__ import annotations

import logging
import time

from .. import metric as _metric
from ..callback import BatchEndParam
from ..initializer import Uniform


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _fire(callbacks, **kwargs):
    """Invoke one-or-many BatchEndParam-style callbacks."""
    if callbacks is None:
        return
    param = BatchEndParam(**kwargs)
    for cb in _as_list(callbacks):
        cb(param)


def _check_input_names(symbol, names, typename, throw):
    """Verify user-declared input names exist among the symbol's
    arguments."""
    args = symbol.list_arguments()
    param_suffixes = ("_weight", "_bias", "_gamma", "_beta")
    for name in names:
        if name in args:
            continue
        inputs = [a for a in args if not a.endswith(param_suffixes)]
        msg = (f"You created Module with Module(..., {typename}_names="
               f"{names}) but input with name '{name}' is not found in "
               f"symbol.list_arguments(). Did you mean one of:\n\t"
               + "\n\t".join(inputs))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    """Abstract module: bind -> init_params -> init_optimizer ->
    (forward_backward, update)* with score on top."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0):
        """Evaluate eval_metric over eval_data."""
        assert self.binded and self.params_initialized
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        seen = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            _fire(batch_end_callback, epoch=epoch, nbatch=nbatch,
                  eval_metric=eval_metric, locals=locals())
            seen += 1
        _fire(score_end_callback, epoch=epoch, nbatch=seen,
              eval_metric=eval_metric, locals=locals())
        return eval_metric.get_name_value()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None):
        """Bind + init, then the epoch loop of forward_backward / update
        / metrics / callbacks / eval."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            started = time.time()
            eval_metric.reset()
            nbatch = -1
            for nbatch, batch in enumerate(train_data):
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                _fire(batch_end_callback, epoch=epoch, nbatch=nbatch,
                      eval_metric=eval_metric, locals=locals())
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - started)
            # surface trained values to the module-level dicts (and to
            # epoch callbacks)
            args, auxs = self.get_params()
            self.set_params(args, auxs)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, args, auxs)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # ------------------------------------------------------ parameters
    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # ----------------------------------------------------- computation
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    @property
    def symbol(self):
        return self._symbol
