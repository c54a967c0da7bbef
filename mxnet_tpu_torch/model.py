"""Model-level helpers: the kvstore decision and the parameter update,
and checkpoint save/load. The counterpart of mxnet_tpu/model.py.

A checkpoint is `prefix-symbol.json` (the graph JSON, byte-identical to
the JAX package's for the same graph) plus `prefix-%04d.params` (the
NDArray container of ndarray.save, keys `arg:<name>` then
`aux:<name>`), so either package loads the other's checkpoints.

The store helpers are the JAX package's: `_create_kvstore` decides the
store and whether the optimizer runs on it, `_initialize_kvstore` puts
each parameter into it, and each step's update either pushes the
gradients and pulls the weights (`_update_params_on_kvstore`) or pushes
and pulls the gradients and runs the updater on every device copy
(`_update_params`). `fit_elastic` joins an elastic job as a worker
(`elastic/`).
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError


def _create_kvstore(kvstore, num_device, arg_params, plan=None):
    """(kvstore, update_on_kvstore) (reference model.py:40-66): no store
    for None, nor for a name other than 'dist*'/'tpu' on one device; a
    store of that name otherwise, whose optimizer runs on the store
    unless it is 'local' and every parameter is smaller than 16 M
    elements. A sharding.ShardingPlan is attached to plan-aware stores
    (kvstore('tpu'))."""
    from . import kvstore as kvs

    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore \
                and "tpu" not in kvstore:
            # a single device needs no store at all
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(a.size) for a in arg_params.values()) \
                    if arg_params else 0
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    elif plan is not None and hasattr(kv, "attach_plan"):
        kv.attach_plan(plan)
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init every parameter's key in one call (across processes, rank 0's
    values in one broadcast a dtype); with the optimizer on the store,
    pull the initial weights back into every device copy (reference
    model.py:68-86)."""
    keys = list(range(len(param_arrays)))
    kvstore.init(keys, [arg_params[param_names[i]] for i in keys])
    if update_on_kvstore:
        for idx, param_on_devs in enumerate(param_arrays):
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push every gradient in one call, then pull every weight
    (reference model.py:88-97): the store sums each key's device copies
    (and across processes, in one all-reduce a dtype), runs its updater,
    and the pull copies the new weight into each device copy."""
    indices = [i for i, g in enumerate(grad_arrays) if g[0] is not None]
    if not indices:
        return
    kvstore.push(indices, [grad_arrays[i] for i in indices],
                 priority=[-i for i in indices])
    for i in indices:
        kvstore.pull(i, param_arrays[i], priority=-i)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """The update with the optimizer off the store: with a store, each
    gradient is pushed and the merged sum pulled back into every device
    copy (reference model.py:99-130); then the updater on each device
    copy of every parameter with a gradient, one optimizer state per
    (key, device copy) as in the reference. An optimizer with
    `update_multi` takes all of them in one multi-tensor call."""
    indices, weights, grads = [], [], []
    for index, (arg_list, grad_list) in enumerate(
            zip(param_arrays, grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            kvstore.push(index, grad_list, priority=-index)
            kvstore.pull(index, grad_list, priority=-index)
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
    multi(indices, weights, grads,
          [updater.state_for(i, w) for i, w in zip(indices, weights)])


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
    """Train as one worker of an elastic job (docs/elastic.md).

    The membership-tolerant sibling of `fit_auto_resume`: instead of
    checkpoint/restart choreography, this process dials the
    ElasticCoordinator at `connect` ('host:port'), is bootstrapped
    with the authoritative params for its rank, and runs lock-step
    global steps until the job completes — surviving every membership
    change in between (another worker's preemption shrinks the world;
    this process keeps training with re-keyed shard ownership).

    Auto-rejoin is built in: a lost coordinator connection re-dials
    within the MXNET_ELASTIC_REJOIN_MS budget (`rejoin_ms` kwarg
    overrides) and rejoins as a fresh member through the normal
    re-grow transition. Returns (reason, final_params) — reason
    'complete' when the job ran to its last step. `ctx` (a worker
    kwarg) is where the gradients are computed: the current context
    when omitted, the card unless the CPU is named.

    `num_retries` is accepted as an alias of `rejoin_ms` expressed in
    heartbeat periods for drop-in symmetry with kvstore-style APIs.
    """
    from .elastic.agent import run_worker
    from .elastic import config as _ecfg

    rejoin_ms = worker_kwargs.pop("rejoin_ms", None)
    if rejoin_ms is None and num_retries is not None:
        rejoin_ms = int(num_retries) * _ecfg.heartbeat_ms()
    return run_worker(connect, entry, config=config,
                      rejoin_ms=rejoin_ms, **worker_kwargs)
