"""Model-level helpers: the kvstore decision and the parameter update,
and checkpoint save/load. The counterpart of mxnet_tpu/model.py.

A checkpoint is `prefix-symbol.json` (the graph JSON, byte-identical to
the JAX package's for the same graph) plus `prefix-%04d.params` (the
NDArray container of ndarray.save, keys `arg:<name>` then
`aux:<name>`), so either package loads the other's checkpoints.

This port trains on one device with no KVStore: `kvstore` may be None
or "local" (with one device MXNet uses no store at all); any other
store, "local" over several devices, and `fit_elastic` raise.
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore): (None, False) for None, and for
    "local" on one device, which needs no store at all."""
    if kvstore is None or (kvstore == "local" and num_device == 1):
        return (None, False)
    raise MXNetError(f"kvstore={kvstore!r} over {num_device} device(s): "
                     "this port trains on one device with no store (None "
                     "or 'local'); the store waits for the KVStore of the "
                     "multi-device slice (ROADMAP.md A.5.2)")


def _update_params(param_arrays, grad_arrays, updater, num_device):
    """The parameter update with no store: the updater on each device
    copy of every parameter with a gradient, one optimizer state per
    (key, device copy) as in the reference. An optimizer with
    `update_multi` takes all of them in one multi-tensor call."""
    indices, weights, grads = [], [], []
    for index, (arg_list, grad_list) in enumerate(
            zip(param_arrays, grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            indices.append(index * num_device + k)
            weights.append(w)
            grads.append(g)
    optimizer = getattr(updater, "optimizer", None)
    multi = getattr(optimizer, "update_multi", None)
    if multi is None:
        for index, w, g in zip(indices, weights, grads):
            updater(index, g, w)
        return
    for index, w in zip(indices, weights):
        if index not in updater.states:
            updater.states[index] = optimizer.create_state(index, w)
    multi(indices, weights, grads, [updater.states[i] for i in indices])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write prefix-symbol.json and prefix-%04d.params."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint; the arrays on
    the host."""
    symbol = sym.load(f"{prefix}-symbol.json")
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError(f"Invalid param file: bad key {k!r}")
    return (symbol, arg_params, aux_params)


def fit_elastic(connect, entry, config=None, num_retries=None,
                **worker_kwargs):
    """Elastic training (docs/elastic.md) is not ported."""
    raise MXNetError("fit_elastic waits for the control-plane slice "
                     "(ROADMAP.md A.10): the port has no elastic "
                     "coordinator")
