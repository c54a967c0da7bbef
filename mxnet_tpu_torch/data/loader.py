"""Multi-worker background batch loader over pluggable sources.

Replaces ad-hoc `NDArrayIter`/`PrefetchingIter` stacking in production
loops: a `DataSource` answers "give me these rows", a `ShardedSampler`
decides WHICH rows (epoch-keyed, per-host shard), and `DataLoader` runs
`MXNET_DATA_WORKERS` producer threads that assemble batches into
bounded per-worker queues.

Design points, mirroring the serving batcher (serving/batcher.py):

- **Bounded queue + backpressure.** Each worker's queue holds at most
  `MXNET_DATA_QUEUE_CAP` batches; a producer that runs ahead blocks on
  `put` (host RAM stays bounded no matter how slow the consumer is).
- **Fast-fail.** A worker exception is re-raised on the consumer's very
  next `next()` (no silent hang on an empty queue), and a closed
  loader raises `DataPipelineError` instead of blocking forever.
- **Deterministic order.** Batch k is ALWAYS produced by worker
  `k % num_workers` and consumed from that worker's queue, so the
  delivered stream is identical for any worker count — parallelism
  never perturbs the sample order the sampler fixed.
- **Resumable.** (seed, epoch, position) fully describes the stream;
  `state_dict()`/`load_state_dict()` round-trip it (state.py), and
  workers restart mid-epoch at any position with a bit-identical
  remaining batch sequence.

Shutdown reuses the `PrefetchingIter.close()` re-signal pattern
(io.py): the stop flag flips first, then every blocked producer is
woken repeatedly until it observes the flag and exits — bounded join,
no leaked workers.

The port's copy of mxnet_tpu/data/loader.py: the same batches, orders
and state files. `next()` hands out host NDArrays over the batch's own
numpy buffers (no copy); the executor group, or a DevicePrefetchIter
over this loader, moves them to the card.
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter, _init_data
from ..ndarray import NDArray
from . import stats as _stats
from .sampler import ShardedSampler

STATE_FORMAT = "mxnet_tpu/data_state_v1"


def _host(a):
    """A host NDArray over the numpy batch array `a` (each batch is
    freshly assembled by its source, so no copy is needed)."""
    return NDArray(torch.from_numpy(np.ascontiguousarray(a)), ctx=cpu())


class DataPipelineError(MXNetError):
    """Errors of the mxnet_tpu.data tier (worker death, closed loader,
    state mismatch)."""


# ---------------------------------------------------------------- sources
class DataSource(object):
    """Random-access row provider a DataLoader batches over.

    Contract: `__len__` is the sample count; `read(indices)` returns
    `(data_arrays, label_arrays)` — lists of numpy arrays with the
    selected rows stacked on axis 0, one entry per data/label name —
    and must be safe to call from multiple worker threads."""

    def __len__(self):
        raise NotImplementedError()

    def read(self, indices):
        raise NotImplementedError()

    @property
    def data_descs(self):
        """Per-sample DataDescs (no batch axis): [(name, shape, dtype)]."""
        raise NotImplementedError()

    @property
    def label_descs(self):
        raise NotImplementedError()


class ArraySource(DataSource):
    """In-memory arrays (the NDArrayIter-style source). Accepts the
    same data/label forms as NDArrayIter (_init_data)."""

    def __init__(self, data, label=None, data_name="data",
                 label_name="softmax_label"):
        self._data = _init_data(data, allow_empty=False,
                                default_name=data_name)
        self._label = _init_data(label, allow_empty=True,
                                 default_name=label_name)
        self._n = self._data[0][1].shape[0]
        for name, arr in self._data + self._label:
            if arr.shape[0] != self._n:
                raise DataPipelineError(
                    f"array {name!r} has {arr.shape[0]} rows, "
                    f"expected {self._n}")

    def __len__(self):
        return self._n

    def read(self, indices):
        return ([arr[indices] for _, arr in self._data],
                [arr[indices] for _, arr in self._label])

    @property
    def data_descs(self):
        return [DataDesc(k, v.shape[1:], v.dtype) for k, v in self._data]

    @property
    def label_descs(self):
        return [DataDesc(k, v.shape[1:], v.dtype)
                for k, v in self._label]


class CSVSource(ArraySource):
    """CSV files materialized to memory (CSVIter's format: data_csv +
    optional label_csv, fixed data_shape per row)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), data_name="data",
                 label_name="softmax_label"):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",",
                               dtype=np.float32, ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        super().__init__(data, label, data_name=data_name,
                         label_name=label_name)


class RecordSource(DataSource):
    """MXIndexedRecordIO-backed source: `decode_fn(payload_bytes)` maps
    one record to `(data_row, label_row)` numpy arrays. Each worker
    thread gets its own reader handle (file position is per-handle
    state; sharing one across threads would interleave seeks)."""

    def __init__(self, idx_path, rec_path, decode_fn, data_name="data",
                 label_name="softmax_label"):
        from ..recordio import MXIndexedRecordIO

        self._idx_path = idx_path
        self._rec_path = rec_path
        self._decode = decode_fn
        self._make_reader = lambda: MXIndexedRecordIO(
            idx_path, rec_path, "r")
        self._local = threading.local()
        probe = self._make_reader()
        try:
            self._keys = list(probe.keys)
            if not self._keys:
                raise DataPipelineError(
                    f"empty record index {idx_path}")
            d0, l0 = decode_fn(probe.read_idx(self._keys[0]))
            d0, l0 = np.asarray(d0), np.asarray(l0)
        finally:
            probe.close()
        self._data_name, self._label_name = data_name, label_name
        self._dshape, self._ddtype = d0.shape, d0.dtype
        self._lshape, self._ldtype = l0.shape, l0.dtype

    def __len__(self):
        return len(self._keys)

    def _reader(self):
        r = getattr(self._local, "reader", None)
        if r is None:
            r = self._local.reader = self._make_reader()
        return r

    def read(self, indices):
        reader = self._reader()
        data = np.empty((len(indices),) + self._dshape, self._ddtype)
        label = np.empty((len(indices),) + self._lshape, self._ldtype)
        for row, i in enumerate(indices):
            d, lab = self._decode(reader.read_idx(self._keys[int(i)]))
            data[row] = d
            label[row] = lab
        return [data], [label]

    @property
    def data_descs(self):
        return [DataDesc(self._data_name, self._dshape, self._ddtype)]

    @property
    def label_descs(self):
        return [DataDesc(self._label_name, self._lshape, self._ldtype)]


def as_source(data, label=None):
    """Coerce arrays/dicts (or an existing DataSource) to a DataSource."""
    if isinstance(data, DataSource):
        return data
    return ArraySource(data, label)


# ----------------------------------------------------------------- loader
class DataLoader(DataIter):
    """Sharded, resumable, multi-worker batch loader (a DataIter:
    drop-in for Module.fit).

    One epoch is one pass over THIS host's shard; `reset()` advances to
    the next epoch (re-keying the permutation), `set_epoch(e)` pins the
    epoch explicitly (fit calls it, so resumed runs re-derive the right
    global order), and `state_dict()`/`load_state_dict()` checkpoint
    the exact stream position (docs/data.md resume contract)."""

    def __init__(self, source, batch_size, label=None, sampler=None,
                 num_workers=None, queue_cap=None, seed=None,
                 shard_id=None, num_shards=None, shuffle=True):
        from .. import utils as _utils

        super().__init__(int(batch_size))
        self._source = as_source(source, label)
        if seed is None:
            seed = _utils.getenv("MXNET_DATA_SEED")
        if sampler is None:
            sampler = ShardedSampler(
                len(self._source), batch_size, seed=seed,
                shard_id=shard_id, num_shards=num_shards,
                shuffle=shuffle)
        self._sampler = sampler
        self._nw = max(1, int(num_workers if num_workers is not None
                              else _utils.getenv("MXNET_DATA_WORKERS")))
        self._cap = max(1, int(queue_cap if queue_cap is not None
                               else _utils.getenv("MXNET_DATA_QUEUE_CAP")))
        self._pos = 0
        self.last_loaded_at = None  # perf_counter: the last batch decoded
        self._closed = False
        self._stop = threading.Event()
        self._threads = []
        self._queues = []
        self._errors = []
        self._start()

    # ------------------------------------------------------- worker side
    def _start(self):
        """Spawn producers for the current (epoch, position)."""
        self._stop = threading.Event()
        self._errors = []
        self._queues = [_queue.Queue(maxsize=self._cap)
                        for _ in range(self._nw)]
        start, stop_evt = self._pos, self._stop

        def work(wid, q):
            try:
                # worker `wid` owns batches k with k % nw == wid — the
                # assignment is a function of k alone, so a restart at
                # any position reproduces the identical partition
                k = start + (wid - start) % self._nw
                while k < self._sampler.batches_per_epoch:
                    if stop_evt.is_set():
                        return
                    payload = self._source.read(
                        self._sampler.batch_indices(k))
                    nbytes = sum(a.nbytes for part in payload
                                 for a in part)
                    done = time.perf_counter()
                    while not stop_evt.is_set():
                        try:
                            q.put((k, payload, nbytes, done),
                                  timeout=0.05)
                            break
                        except _queue.Full:
                            continue  # backpressure: consumer is behind
                    k += self._nw
            except Exception as exc:  # noqa: BLE001 — surfaced to consumer
                self._errors.append(exc)

        self._threads = [
            threading.Thread(target=work, args=(i, self._queues[i]),
                             daemon=True)
            for i in range(self._nw)
        ]
        for t in self._threads:
            t.start()

    def _halt(self, timeout=5.0):
        """Stop + join the current producers; drain queues so a blocked
        put wakes (the PrefetchingIter.close re-signal pattern)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            while t.is_alive() and time.monotonic() < deadline:
                for q in self._queues:
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        pass
                t.join(0.05)
        self._threads = []
        self._queues = []

    # ----------------------------------------------------- consumer side
    def _pop_raw(self):
        """(data_arrays, label_arrays) of the next batch — host numpy,
        in sampler order regardless of worker count."""
        if self._closed:
            raise DataPipelineError("DataLoader is closed")
        if self._pos >= self._sampler.batches_per_epoch:
            raise StopIteration
        q = self._queues[self._pos % self._nw]
        while True:
            if self._errors:
                raise DataPipelineError(
                    f"loader worker died: {self._errors[0]!r}"
                ) from self._errors[0]
            try:
                k, payload, nbytes, done = q.get(timeout=0.1)
                break
            except _queue.Empty:
                if self._closed:
                    raise DataPipelineError("DataLoader is closed")
        assert k == self._pos, f"out-of-order batch {k} != {self._pos}"
        self._pos += 1
        self.last_loaded_at = done
        _stats.note_host_batch(nbytes)
        return payload

    def next(self):
        data, label = self._pop_raw()
        return DataBatch(
            data=[_host(a) for a in data],
            label=[_host(a) for a in label],
            pad=0, index=None,
            provide_data=self.provide_data,
            provide_label=self.provide_label,
        )

    def iter_next(self):
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return 0

    # --------------------------------------------------- epoch + resume
    @property
    def epoch(self):
        return self._sampler.epoch

    @property
    def position(self):
        """Batches consumed so far this epoch."""
        return self._pos

    @property
    def batches_per_epoch(self):
        return self._sampler.batches_per_epoch

    def __len__(self):
        return self._sampler.batches_per_epoch

    def reset(self):
        """End of epoch: advance to the next epoch's permutation."""
        if self._closed:
            raise DataPipelineError("DataLoader is closed")
        self._halt()
        self._sampler.set_epoch(self._sampler.epoch + 1)
        self._pos = 0
        _stats.note_epoch()
        self._start()

    def set_epoch(self, epoch):
        """Pin the epoch (fit calls this each epoch): a no-op when the
        loader is already positioned in `epoch` — preserving a
        mid-epoch resume position — otherwise rewinds to the start of
        `epoch`."""
        if self._closed:
            raise DataPipelineError("DataLoader is closed")
        if int(epoch) == self._sampler.epoch:
            return
        self._halt()
        self._sampler.set_epoch(epoch)
        self._pos = 0
        self._start()

    def state_dict(self):
        """Checkpointable stream position: replaying (seed, epoch,
        position) on the same shard yields the bit-identical remaining
        batch sequence."""
        return {
            "format": STATE_FORMAT,
            "seed": self._sampler.seed,
            "epoch": self._sampler.epoch,
            "position": self._pos,
            "batch_size": self.batch_size,
            "num_samples": self._sampler.num_samples,
            "shard_id": self._sampler.shard_id,
            "num_shards": self._sampler.num_shards,
        }

    def load_state_dict(self, state):
        if state.get("format") != STATE_FORMAT:
            raise DataPipelineError(
                f"unrecognized data state format "
                f"{state.get('format')!r}")
        for key in ("batch_size", "num_samples", "shard_id",
                    "num_shards", "seed"):
            have = getattr(self._sampler, key, None)
            if key == "batch_size":
                have = self.batch_size
            if int(state[key]) != int(have):
                raise DataPipelineError(
                    f"data state mismatch: {key} was {state[key]}, "
                    f"loader has {have}")
        self._halt()
        self._sampler.set_epoch(int(state["epoch"]))
        self._pos = int(state["position"])
        self._start()

    # --------------------------------------------------------- lifecycle
    def close(self, timeout=5.0):
        """Shut the producers down. Idempotent; safe from __del__ and
        context-manager exit."""
        if self._closed:
            return
        self._closed = True
        self._halt(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -------------------------------------------------------- DataIter
    @property
    def provide_data(self):
        return [DataDesc(d.name, (self.batch_size,) + d.shape, d.dtype)
                for d in self._source.data_descs]

    @property
    def provide_label(self):
        return [DataDesc(d.name, (self.batch_size,) + d.shape, d.dtype)
                for d in self._source.label_descs]
