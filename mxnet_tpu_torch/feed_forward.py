"""FeedForward: the legacy estimator-style training API
(mxnet_tpu/feed_forward.py, after the reference's python/mxnet/model.py
FeedForward), a facade over Module: the symbol and training settings in
the constructor, then fit / predict / score / save / load / create.

As every entry point of the port, it runs on the card unless `ctx`
names another context (the JAX package's default is the host).
Sharding plans, monitors and kvstores other than None/"local" wait for
later slices.
"""
from __future__ import annotations

import logging

import numpy as np

from . import initializer as init
from . import io as mxio
from . import metric as _metric
from .base import MXNetError
from .context import current_context
from .model import load_checkpoint, save_checkpoint


def _as_data_iter(X, y=None, batch_size=128, shuffle=False,
                  label_name="softmax_label"):
    if isinstance(X, mxio.DataIter):
        return X
    X = np.asarray(X)
    if y is not None:
        y = np.asarray(y)
    batch_size = min(batch_size, X.shape[0])
    return mxio.NDArrayIter(X, y, batch_size=batch_size, shuffle=shuffle,
                            label_name=label_name)


class FeedForward:
    """Estimator: symbol and training configuration in the constructor,
    then fit(X, y)."""

    def __init__(self, symbol, ctx=None, num_epoch=None,
                 epoch_size=None, optimizer="sgd",
                 initializer=init.Uniform(0.01), numpy_batch_size=128,
                 arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0,
                 sharding=None, **kwargs):
        if sharding is not None:
            raise MXNetError("FeedForward(sharding=...) waits for the "
                             "multi-device slice (ROADMAP.md A.5.2)")
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else [current_context()]
        if not isinstance(self.ctx, (list, tuple)):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    # ------------------------------------------------------------- train
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        from .module import Module

        if monitor is not None:
            raise MXNetError("monitors are not ported yet (ROADMAP.md A.8)")
        data = _as_data_iter(X, y, self.numpy_batch_size, shuffle=True)
        if eval_data is not None and not isinstance(eval_data,
                                                    mxio.DataIter):
            ex, ey = eval_data
            eval_data = _as_data_iter(ex, ey, self.numpy_batch_size)
        label_names = [d.name for d in (data.provide_label or [])]
        mod = Module(self.symbol,
                     data_names=[d.name for d in data.provide_data],
                     label_names=label_names or None, context=self.ctx,
                     logger=logger or logging.getLogger())
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self.kwargs or None,
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                allow_missing=self.arg_params is not None,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    # ----------------------------------------------------------- predict
    def _bind_for_pred(self, data):
        from .module import Module

        # label arguments stay labels (not parameters) though inference
        # binds without label shapes
        label_names = [n for n in self.symbol.list_arguments()
                       if n.endswith("_label")]
        mod = Module(self.symbol,
                     data_names=[d.name for d in data.provide_data],
                     label_names=label_names or None, context=self.ctx)
        mod.bind(data_shapes=data.provide_data, label_shapes=None,
                 for_training=False)
        if self.arg_params is None:
            raise MXNetError("model has not been trained or loaded")
        mod.set_params(self.arg_params, self.aux_params or {},
                       allow_missing=False)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The first output of every batch of X, as one host array."""
        data = _as_data_iter(X, None, self.numpy_batch_size)
        if reset:
            data.reset()
        mod = self._bind_for_pred(data)
        outputs = []
        for n, batch in enumerate(data):
            if num_batch is not None and n >= num_batch:
                break
            mod.forward(batch, is_train=False)
            out = mod.get_outputs()[0].asnumpy()
            pad = getattr(batch, "pad", 0) or 0
            if pad:
                out = out[: out.shape[0] - pad]
            outputs.append(out)
        return np.concatenate(outputs, axis=0)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """eval_metric (a name or an EvalMetric) over X's batches."""
        data = _as_data_iter(X, None, self.numpy_batch_size)
        if reset:
            data.reset()
        mod = self._bind_for_pred(data)
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        for n, batch in enumerate(data):
            if num_batch is not None and n >= num_batch:
                break
            mod.forward(batch, is_train=False)
            eval_metric.update(batch.label, mod.get_outputs())
        return eval_metric.get()[1]

    # -------------------------------------------------------- checkpoint
    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer="sgd",
               initializer=init.Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Train a new model from scratch."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
