"""The executor group of a Module (mxnet_tpu/module/executor_group.py),
for one device: the executor bound for the batch shapes, the grad_req
table (parameters 'write', data only with inputs_need_grad, labels and
fixed parameters 'null'), the per-name array lists Module updates, and
the batch loading (host batch -> the executor's device arrays).

Splitting a batch across several devices waits for the KVStore slice.
"""
from __future__ import annotations

import logging

from .. import metric as _metric
from ..base import MXNetError
from ..io import DataDesc


class DataParallelExecutorGroup:
    """One executor on one context."""

    def __init__(self, symbol, contexts, workload, data_shapes,
                 label_shapes, param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None):
        if len(contexts) != 1:
            raise MXNetError(
                f"Module runs on one device in this port, got {contexts}")
        if shared_group is not None:
            raise MXNetError("shared executor groups (bucketing) are not "
                             "ported yet")
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        if not for_training:
            grad_req = "null"
        data_names = [x[0] for x in data_shapes]
        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = ("null" if k in self.fixed_param_names
                                        else grad_req)
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad \
                        else "null"
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            assert len(grad_req) == len(self.arg_names)
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {
                k: ("null" if k in self.fixed_param_names else "write")
                if k in self.param_names else
                ("write" if inputs_need_grad and k in data_names
                 else "null")
                for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise MXNetError(
                "grad_req must be one of str, list, tuple, or dict.")
        self.bind_exec(data_shapes, label_shapes)

    def bind_exec(self, data_shapes, label_shapes):
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.batch_size = data_shapes[0][1][
            DataDesc.get_batch_axis(getattr(data_shapes[0], "layout",
                                            "NCHW"))]
        context = self.contexts[0]
        shapes = dict(data_shapes)
        types = {x.name: x.dtype for x in data_shapes}
        if label_shapes is not None:
            shapes.update(dict(label_shapes))
            types.update({x.name: x.dtype for x in label_shapes})
        exe = self.symbol.simple_bind(ctx=context, grad_req=self.grad_req,
                                      type_dict=types, **shapes)
        self.execs = [exe]
        self.data_arrays = [[exe.arg_dict[name]] for name, _ in data_shapes]
        self.label_arrays = ([[exe.arg_dict[name]]
                              for name, _ in label_shapes]
                             if label_shapes is not None else None)
        self.param_arrays = [[exe.arg_dict[n]] for n in self.param_names]
        self.grad_arrays = ([[exe.grad_dict[n]]
                             if self.grad_req[n] != "null" else [None]
                             for n in self.param_names]
                            if self.for_training else None)
        self.input_grad_arrays = (
            [[exe.grad_dict[n]] for n, _ in data_shapes
             if n in exe.grad_dict] if self.inputs_need_grad else None)
        self.aux_arrays = [[exe.aux_dict[n]] for n in self.aux_names]

    def get_params(self, arg_params, aux_params):
        for name, block in zip(self.param_names, self.param_arrays):
            block[0].copyto(arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            block[0].copyto(aux_params[name])

    def set_params(self, arg_params, aux_params):
        self.execs[0].copy_params_from(arg_params, aux_params)

    def forward(self, data_batch, is_train=None):
        for src, dst in zip(data_batch.data, self.data_arrays):
            dst[0][:] = src
        if self.label_arrays is not None and data_batch.label:
            for src, dst in zip(data_batch.label, self.label_arrays):
                dst[0][:] = src
        if is_train is None:
            is_train = self.for_training
        self.execs[0].forward(is_train=is_train)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [g[0] for g in self.input_grad_arrays]
        return grads if merge_multi_context else [[g] for g in grads]

    def backward(self, out_grads=None):
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        self.execs[0].backward(out_grads=out_grads)

    def update_metric(self, eval_metric, labels):
        _metric.update_auto(eval_metric, labels, self.execs[0].outputs)
