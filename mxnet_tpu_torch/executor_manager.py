"""DataParallelExecutorManager: the pre-Module multi-device training
helper (mxnet_tpu/executor_manager.py, after the reference's
python/mxnet/executor_manager.py), an adapter over
module.executor_group.DataParallelExecutorGroup, which binds one
executor per context on its slice of each batch.
"""
from __future__ import annotations

import logging

from .base import MXNetError
from .io import DataDesc
from .module.executor_group import DataParallelExecutorGroup
from .module.executor_group import _split_input_slice  # noqa: F401


def _check_arguments(symbol):
    """Reject duplicated argument or aux names."""
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        raise MXNetError(f"Find duplicated argument name: {arg_names}")
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise MXNetError(f"Find duplicated auxiliary name: {aux_names}")


class DataParallelExecutorManager:
    """Executors on several contexts for data parallelism."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        if logger is None:
            logger = logging.getLogger()
        _check_arguments(symbol)
        self.symbol = symbol
        self.ctx = ctx
        self.sym_gen = sym_gen
        num_device = len(ctx)
        logger.info("Start training with %s", [str(c) for c in ctx])
        if work_load_list is None:
            work_load_list = [1] * num_device
        if len(work_load_list) != num_device:
            raise MXNetError(f"work_load_list {work_load_list} does not "
                             f"match {num_device} contexts")
        self.work_load_list = work_load_list
        self.data_shapes = [
            d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in train_data.provide_data]
        self.label_shapes = [
            d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in (train_data.provide_label or [])]
        arg_names = arg_names or symbol.list_arguments()
        aux_names = aux_names or symbol.list_auxiliary_states()
        data_names = {d.name for d in self.data_shapes} | {
            d.name for d in self.label_shapes}
        if param_names is None:
            param_names = [n for n in arg_names if n not in data_names]
        self._arg_names = arg_names
        self._param_names = param_names
        self._aux_names = aux_names
        self._cur_batch = None
        self.execgrp = DataParallelExecutorGroup(
            symbol, ctx, work_load_list, self.data_shapes,
            self.label_shapes or None, param_names, for_training=True,
            inputs_need_grad=False)

    # ------------------------------------------------------------ params
    @property
    def param_names(self):
        return self._param_names

    @property
    def aux_names(self):
        return self._aux_names

    @property
    def param_arrays(self):
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.execgrp.aux_arrays

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """Average the device copies into the given dicts."""
        self.execgrp.get_params(arg_params, aux_params)

    def install_monitor(self, monitor):
        raise MXNetError("monitors are not ported yet (ROADMAP.md A.8)")

    # ------------------------------------------------------------ compute
    def load_data_batch(self, data_batch):
        self._cur_batch = data_batch

    def forward(self, is_train=False):
        self.execgrp.forward(self._cur_batch, is_train=is_train)

    def backward(self):
        self.execgrp.backward()

    @property
    def curr_execgrp(self):
        return self.execgrp

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)
