"""The executor group (mxnet_tpu/module/executor_group.py): one executor
per context, each bound for its slice of the batch.

The batch is split across the contexts by workload (`decide_slices`);
each executor gets the grad_req table (parameters 'write', data only
with inputs_need_grad, labels and fixed parameters 'null'); the group
keeps the per-name array lists (one array per context) that Module and
DataParallelExecutorManager update, loads each batch slice into its
executor's device arrays, merges outputs along the batch axis onto the
first context, and averages parameters across contexts on get_params.

Module trains on one context (several wait for the KVStore slice); the
legacy DataParallelExecutorManager binds several. Shared groups
(bucketing) and reshape are not ported.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import metric as _metric
from .. import ndarray as nd
from ..base import MXNetError
from ..io import DataDesc


def _split_input_slice(batch_size, work_load_list):
    """Slice ranges per device, weighted by workload (the reference's
    executor_manager._split_input_slice)."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


def _load_general(data, targets):
    """Copy each batch array (whole, or the context's slice) into the
    executors' arrays."""
    for d_src, d_targets in zip(data, targets):
        for slice_idx, d_dst in d_targets:
            if d_src.shape == d_dst.shape:
                d_dst[:] = d_src
            else:
                d_dst[:] = d_src[slice_idx.start:slice_idx.stop]


def _merge_multi_context(outputs):
    """Concatenate per-context outputs along the batch axis on the first
    context's device."""
    merged = []
    for arrays in outputs:
        if len(arrays) == 1:
            merged.append(arrays[0])
            continue
        dev = arrays[0].data.device
        merged.append(nd.NDArray(torch.cat([a.data.to(dev) for a in arrays]),
                                 ctx=arrays[0].context))
    return merged


class DataParallelExecutorGroup:
    """Executors for `contexts`, each on its slice of the batch."""

    def __init__(self, symbol, contexts, workload, data_shapes,
                 label_shapes, param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None):
        if shared_group is not None:
            raise MXNetError("shared executor groups (bucketing) are not "
                             "ported yet")
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload if workload else [1] * len(contexts)
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
        self.output_layouts = [
            DataDesc.get_batch_axis(self.symbol[name].attr("__layout__"))
            for name in self.symbol.list_outputs()]
        self.execs = []
        self.bind_exec(data_shapes, label_shapes)

    def decide_slices(self, data_shapes):
        """Split batch_size across the contexts by workload; returns the
        batch axis of each input."""
        major_axis = [DataDesc.get_batch_axis(getattr(x, "layout", "NCHW"))
                      for x in data_shapes]
        for (name, shape), axis in zip(data_shapes, major_axis):
            if axis == -1:
                continue
            batch_size = shape[axis]
            if self.batch_size is not None:
                assert batch_size == self.batch_size, (
                    f"all data must have the same batch size: batch_size = "
                    f"{self.batch_size}, but {name} has shape {shape}")
                continue
            self.batch_size = batch_size
            self.slices = _split_input_slice(batch_size, self.workload)
        return major_axis

    def _sliced_shape(self, shapes, i, major_axis):
        sliced = []
        for desc, axis in zip(shapes, major_axis):
            shape = list(desc.shape if isinstance(desc, DataDesc)
                         else desc[1])
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            name = desc.name if isinstance(desc, DataDesc) else desc[0]
            dtype = desc.dtype if isinstance(desc, DataDesc) else np.float32
            sliced.append(DataDesc(name, tuple(shape), dtype))
        return sliced

    def bind_exec(self, data_shapes, label_shapes):
        """Bind one executor per context for its slice's shapes."""
        self.batch_size = None
        self.slices = None
        self.data_layouts = self.decide_slices(data_shapes)
        self.label_layouts = (self.decide_slices(label_shapes)
                              if label_shapes is not None else None)
        self.execs = []
        for i, context in enumerate(self.contexts):
            descs = self._sliced_shape(data_shapes, i, self.data_layouts)
            if label_shapes is not None:
                descs += self._sliced_shape(label_shapes, i,
                                            self.label_layouts)
            self.execs.append(self.symbol.simple_bind(
                ctx=context, grad_req=self.grad_req,
                type_dict={d.name: d.dtype for d in descs},
                **{d.name: d.shape for d in descs}))
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self._collect_arrays()

    def _collect_arrays(self):
        execs = self.execs
        self.data_arrays = [[(self.slices[i], e.arg_dict[name])
                             for i, e in enumerate(execs)]
                            for name, _ in self.data_shapes]
        self.label_arrays = (
            [[(self.slices[i], e.arg_dict[name])
              for i, e in enumerate(execs)]
             for name, _ in self.label_shapes]
            if self.label_shapes is not None else None)
        self.param_arrays = [[e.arg_dict[name] for e in execs]
                             for name in self.param_names]
        self.grad_arrays = (
            [[e.grad_dict[name] for e in execs]
             if self.grad_req[name] != "null" else [None] * len(execs)
             for name in self.param_names]
            if self.for_training else None)
        data_names = [x[0] for x in self.data_shapes]
        self.input_grad_arrays = (
            [[e.grad_dict[name] for e in execs]
             for name in data_names if name in execs[0].grad_dict]
            if self.inputs_need_grad else None)
        self.aux_arrays = [[e.aux_dict[name] for e in execs]
                           for name in self.aux_names]

    @staticmethod
    def _block_mean(block):
        """The mean of one parameter's copies, on the first copy's
        device."""
        if len(block) == 1:
            return block[0]
        dev = block[0].data.device
        acc = block[0].data.clone()
        for w in block[1:]:
            acc += w.data.to(dev, acc.dtype)
        return nd.NDArray(acc / len(block), ctx=block[0].context)

    def get_params(self, arg_params, aux_params):
        """Copy (the mean across contexts of) each parameter into the
        given dicts."""
        for name, block in zip(self.param_names, self.param_arrays):
            self._block_mean(block).copyto(arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            self._block_mean(block).copyto(aux_params[name])

    def set_params(self, arg_params, aux_params):
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params)

    def forward(self, data_batch, is_train=None):
        _load_general(data_batch.data, self.data_arrays)
        if self.label_arrays is not None and data_batch.label:
            _load_general(data_batch.label, self.label_arrays)
        if is_train is None:
            is_train = self.for_training
        for exe in self.execs:
            exe.forward(is_train=is_train)

    def get_outputs(self, merge_multi_context=True):
        outputs = [[exe.outputs[i] for exe in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        return _merge_multi_context(outputs) if merge_multi_context \
            else outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if merge_multi_context:
            return _merge_multi_context(self.input_grad_arrays)
        return self.input_grad_arrays

    def backward(self, out_grads=None):
        """Backward on each executor with its slice of the head
        gradients (ones when none are given)."""
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        if out_grads is None:
            out_grads = []
        if isinstance(out_grads, nd.NDArray):
            out_grads = [out_grads]
        for i, exe in enumerate(self.execs):
            part = []
            for grad, axis in zip(out_grads, self.output_layouts):
                g = grad.data if isinstance(grad, nd.NDArray) \
                    else torch.as_tensor(np.asarray(grad))
                if axis >= 0 and len(self.execs) > 1:
                    g = g.narrow(axis, self.slices[i].start,
                                 self.slices[i].stop - self.slices[i].start)
                part.append(g)
            exe.backward(out_grads=part or None)

    def update_metric(self, eval_metric, labels):
        """Update the metric with each context's outputs against its
        slice of the labels."""
        for exe, islice in zip(self.execs, self.slices):
            if len(self.execs) == 1:
                part = labels
            else:
                part = [label[islice.start:islice.stop] if axis == 0
                        else label
                        for label, axis in zip(labels,
                                               self.label_layouts or [])]
            _metric.update_auto(eval_metric, part, exe.outputs)
