"""Device-side prefetch: stage the next K batches on the card so the
steady-state training step never blocks on host data
(mxnet_tpu/data/device_prefetch.py).

The host loader (loader.py) overlaps decode with compute; this tier
also overlaps the host-to-device copy. A stager thread pulls host
batches and keeps up to `MXNET_DATA_DEVICE_PREFETCH` of them staged
(2 by default: one being consumed, one landing), so by the time `fit`
asks for batch N+1 its bytes are already on the card, or streaming in,
while step N runs.

On a CUDA context each batch goes through a ring of pinned host buffers
(K + 1 slots, allocated at the first batch and again only when a
batch's shapes change). The work is split by thread:

- the stager thread does host work only: it pulls a host batch, waits
  for a free slot and writes the batch into it. It makes no CUDA call
  once its slots exist. A CUDA call made here can wait for the rest of
  the step on the card while the training loop sits in a synchronizing
  call such as a `.cpu()` (`tools/prefetch_timeline.py` times both
  designs on a card), and a stager held there twice in one batch
  delivers it after it is asked for;
- `next()`, in the consumer's thread, issues the host-to-device copy of
  every slot the stager has filled since the last call (fresh device
  tensors, the side stream, `non_blocking=True`, one event after the
  copies), hands over the oldest batch, and gives back to the stager
  each slot whose copy event has completed.

Three rules keep the stream order right:

- a slot is refilled only after the event of its previous copy has
  completed (the consumer releases it only then; the stager waits for a
  released slot, never on an event);
- before `next()` hands a batch over, the consumer's current stream
  waits on the batch's event (a device-side wait: the host does not
  block);
- each handed-over tensor is `record_stream`ed onto the consumer's
  stream, so the caching allocator does not reuse its memory while
  work queued there may still read it.

On a host context (`mx.cpu()`) the batches are host NDArrays over the
loader's arrays and nothing is copied.

`MXNET_DATA_DEVICE_PREFETCH=0` is the synchronous arm: `next()` pulls
and copies inline. Such a batch was by definition not resident when
asked for, so every one counts as a stall; with prefetch on, a
steady-state epoch counts none (the first K + 1 batches after a reset
are warmup, not stalls).

Resume: `state_dict()` reports the CONSUMED position, not the staged
one: batches the stager pulled ahead but never handed out are not seen,
so a restore replays exactly the unconsumed tail.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from ..context import current_context
from ..io import DataBatch, DataIter
from ..ndarray import NDArray
from . import stats as _stats
from .loader import DataPipelineError


def _host_tensor(a):
    """The host tensor of a numpy array or NDArray (no copy when it
    already lies on the host)."""
    if isinstance(a, NDArray):
        return a._data
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class _PinnedRing:
    """Pinned host slots for the host-to-device copies of one iterator.
    The stager takes free slots in turn and fills them; the consumer
    records each slot's copy event and releases the slot once that
    event has completed."""

    def __init__(self, size):
        self.slots = [None] * size      # per slot: [pinned tensors]
        self.events = [None] * size     # per slot: event of its last copy
        self.free = collections.deque(range(size))
        self.allocations = 0            # slots (re)allocated
        self.reuse_waits = 0            # refills that had to wait

    def buffers(self, i, tensors):
        """Slot i's pinned buffers shaped like `tensors` (allocated at
        its first use and when the shapes change)."""
        slot = self.slots[i]
        if slot is None or len(slot) != len(tensors) or any(
                p.shape != t.shape or p.dtype != t.dtype
                for p, t in zip(slot, tensors)):
            slot = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in tensors]
            self.slots[i] = slot
            self.allocations += 1
        return slot

    def release_done(self, block=False):
        """Free every slot whose copy has completed (consumer thread);
        with `block`, first wait for the oldest copy when no slot is
        free. Returns how many were freed."""
        if block and not self.free:
            pending = [e for e in self.events if e is not None]
            if pending:
                pending[0].synchronize()
        n = 0
        for i, event in enumerate(self.events):
            if event is not None and event.query():
                self.events[i] = None
                self.free.append(i)
                n += 1
        return n


class DevicePrefetchIter(DataIter):
    """Wrap a DataIter or DataLoader; yield DataBatches whose arrays are
    already on the context's device. A DataIter drop-in (Module.fit
    consumes it unchanged); forwards the resume protocol (set_epoch,
    state_dict, load_state_dict) when the inner iterator supports it."""

    TIMELINE_CAP = 4096

    def __init__(self, data_iter, ctx=None, prefetch=None):
        from .. import utils as _utils

        super().__init__(getattr(data_iter, "batch_size", 0))
        self._inner = data_iter
        self._ctx = ctx if ctx is not None else current_context()
        self._device = self._ctx.torch_device()
        self._cuda = self._device.type == "cuda"
        self._k = int(prefetch if prefetch is not None
                      else _utils.getenv("MXNET_DATA_DEVICE_PREFETCH"))
        self._cond = threading.Condition()
        self._staged = collections.deque()   # filled by the stager
        self._issued = collections.deque()   # copies issued by next()
        self._exhausted = False
        self._error = None
        self._warmup = self._k + 1
        self._consumed = 0
        self._timeline = collections.deque(maxlen=self.TIMELINE_CAP)
        self._closed = False
        self._stop = threading.Event()
        self._thread = None
        self._stream = None
        # a slot per staged batch and one being filled
        self._ring = _PinnedRing(max(self._k, 1) + 1) if self._cuda \
            else None
        if self._k > 0:
            self._start()

    # ------------------------------------------------------------ stager
    def _fetch_inner(self):
        """One host batch as (data_arrays, label_arrays, provide_data,
        provide_label): raw numpy from a DataLoader, NDArrays from any
        other DataIter."""
        if hasattr(self._inner, "_pop_raw"):
            data, label = self._inner._pop_raw()
            return (data, label, self._inner.provide_data,
                    self._inner.provide_label)
        batch = self._inner.next()
        return (batch.data, batch.label or [],
                batch.provide_data or self.provide_data,
                batch.provide_label or self.provide_label)

    def _take_slot(self, stop_evt):
        """The next free slot's index (stager thread; waits while every
        slot's copy is still in flight), or None when stopped."""
        ring = self._ring
        with self._cond:
            if not ring.free:
                ring.reuse_waits += 1
            while not ring.free and not stop_evt.is_set():
                self._cond.wait(0.05)
            if stop_evt.is_set():
                return None
            return ring.free.popleft()

    def _make_item(self, stop_evt):
        """One staged item: {"data", "label", "pd", "pl", "marks"} and,
        on a CUDA context, the pinned slot the arrays were written into
        ("slot"; host arrays on a host context). None when stopped."""
        marks = {"pull": time.perf_counter()}
        data, label, pd, pl = self._fetch_inner()
        marks["pulled"] = time.perf_counter()
        marks["loaded"] = getattr(self._inner, "last_loaded_at", None)
        item = {"data": list(data), "label": list(label), "pd": pd,
                "pl": pl, "marks": marks, "slot": None}
        host = [_host_tensor(a) for a in item["data"] + item["label"]]
        if self._cuda and any(h.device.type == "cpu" for h in host):
            slot = self._take_slot(stop_evt)
            if slot is None:
                return None
            marks["ring"] = time.perf_counter()
            pinned = iter(self._ring.buffers(
                slot, [h for h in host if h.device.type == "cpu"]))
            host = [next(pinned).copy_(h) if h.device.type == "cpu"
                    else h for h in host]
            item["slot"] = slot
        item["host"] = host
        marks["host"] = time.perf_counter()
        return item

    def _stage_loop(self, stop_evt):
        try:
            while not stop_evt.is_set():
                with self._cond:
                    while (len(self._staged) + len(self._issued)
                           >= self._k and not stop_evt.is_set()):
                        self._cond.wait(0.05)
                if stop_evt.is_set():
                    return
                try:
                    item = self._make_item(stop_evt)
                except StopIteration:
                    with self._cond:
                        self._exhausted = True
                        self._cond.notify_all()
                    return
                if item is None:
                    return
                item["marks"]["staged"] = time.perf_counter()
                with self._cond:
                    if stop_evt.is_set():
                        if item["slot"] is not None:
                            self._ring.free.append(item["slot"])
                        return
                    self._staged.append(item)
                    _stats.note_depth(len(self._staged) + len(self._issued))
                    self._cond.notify_all()
        except Exception as exc:  # noqa: BLE001 — surfaced in next()
            with self._cond:
                self._error = exc
                self._cond.notify_all()

    def _start(self, fill_timeout=10.0):
        self._stop = threading.Event()
        with self._cond:
            # a prior stager that outlived _halt's bounded join may
            # still be alive and flips these flags under the cond
            self._exhausted = False
            self._error = None
            self._staged.clear()
            self._issued.clear()
        self._thread = threading.Thread(
            target=self._stage_loop, args=(self._stop,), daemon=True)
        self._thread.start()
        # pre-fill barrier: hand control back once K batches are staged
        # (init and reset are sync points of fit already), so the
        # epoch's first steps land on staged batches
        deadline = time.monotonic() + fill_timeout
        with self._cond:
            while (len(self._staged) < self._k and not self._exhausted
                   and self._error is None
                   and time.monotonic() < deadline):
                self._cond.wait(0.05)

    def _halt(self, timeout=5.0):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        with self._cond:
            self._staged.clear()
            self._issued.clear()
            self._exhausted = False
            self._error = None
            ring = self._ring
            if ring is not None:
                # every slot free again once its last copy has landed
                for i, event in enumerate(ring.events):
                    if event is not None:
                        event.synchronize()
                        ring.events[i] = None
                ring.free = collections.deque(range(len(ring.slots)))

    # ---------------------------------------------------------- consumer
    def _issue(self, item):
        """Item -> (DataBatch on the context's device, copy event or None,
        marks). On a CUDA context this enqueues the copies on the side
        stream (consumer thread) and records the slot's event."""
        marks = item["marks"]
        n = len(item["data"])
        if not self._cuda:
            out = [a if isinstance(a, NDArray) and a._data.device
                   == self._device else NDArray(
                       _host_tensor(a).to(self._device), ctx=self._ctx)
                   for a in item["data"] + item["label"]]
            event = None
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self._device)
            with torch.cuda.device(self._device), \
                    torch.cuda.stream(self._stream):
                dev = []
                for h in item["host"]:
                    if h.device.type != "cpu":
                        # already on a device: order after its producer
                        self._stream.wait_stream(
                            torch.cuda.current_stream(h.device))
                    d = torch.empty(h.shape, dtype=h.dtype,
                                    device=self._device)
                    d.copy_(h, non_blocking=True)
                    dev.append(d)
                event = torch.cuda.Event()
                event.record(self._stream)
            if item["slot"] is not None:
                with self._cond:
                    self._ring.events[item["slot"]] = event
            out = [NDArray(t, ctx=self._ctx) for t in dev]
        marks["issued"] = time.perf_counter()
        batch = DataBatch(data=out[:n], label=out[n:], pad=0, index=None,
                          provide_data=item["pd"], provide_label=item["pl"])
        return batch, event, marks

    def _hand_over(self, batch, event):
        """Order the consumer's stream after the batch's copy and tie the
        tensors' memory to that stream."""
        if event is None:
            return batch
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(event)
        for arr in list(batch.data) + list(batch.label or ()):
            arr._data.record_stream(consumer)
        return batch

    def next(self):
        if self._closed:
            raise DataPipelineError("DevicePrefetchIter is closed")
        if self._k <= 0:
            return self._next_sync()
        t0 = time.perf_counter()
        waited = False
        with self._cond:
            while (not self._staged and not self._issued
                   and not self._exhausted and self._error is None):
                waited = True
                # the stager may be waiting for a slot whose copy has
                # landed since the last call: only this thread frees it
                if self._ring is not None and self._ring.release_done():
                    self._cond.notify_all()
                self._cond.wait(0.05)
            if self._error is not None:
                raise DataPipelineError(
                    f"device-prefetch stager died: {self._error!r}"
                ) from self._error
            staged = list(self._staged)
            self._staged.clear()
            if not staged and not self._issued:
                raise StopIteration
        waited_s = time.perf_counter() - t0
        # the copies of everything the stager filled since the last call
        # (this thread: it is never inside a blocking call here)
        for item in staged:
            self._issued.append(self._issue(item))
        batch, event, marks = self._issued.popleft()
        copied = event is None or event.query()
        if self._ring is not None:
            with self._cond:
                if self._ring.release_done():
                    self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()  # room for the stager
        marks.update(asked=t0, served=time.perf_counter(), copied=copied,
                     epoch=self.epoch, position=self._consumed)
        self._timeline.append(marks)
        # the first `prefetch`+1 batches after init/reset are pipeline
        # fill: the queue starts empty, and fit's dispatch window lets
        # the consumer run one batch past the staging depth before the
        # device's backpressure holds it
        _stats.note_serve(waited_s, stalled=waited and self._warmup == 0)
        if self._warmup:
            self._warmup -= 1
        self._consumed += 1
        return self._hand_over(batch, event)

    def _next_sync(self):
        """MXNET_DATA_DEVICE_PREFETCH=0: pull and copy inline. The data
        was not resident when asked for: every batch is a stall."""
        t0 = time.perf_counter()
        if self._ring is not None:
            # no stager: this thread frees the slot it is about to fill
            with self._cond:
                self._ring.release_done(block=True)
        item = self._make_item(self._stop)
        item["marks"]["staged"] = item["marks"]["host"]
        batch, event, marks = self._issue(item)
        marks.update(asked=t0, served=time.perf_counter(), copied=False,
                     epoch=self.epoch, position=self._consumed)
        self._timeline.append(marks)
        _stats.note_serve(time.perf_counter() - t0, stalled=True)
        self._consumed += 1
        return self._hand_over(batch, event)

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
        return getattr(self._inner, "epoch", None)

    @property
    def position(self):
        """Batches CONSUMED this epoch (staged-ahead ones excluded)."""
        return self._consumed

    @property
    def batches_per_epoch(self):
        return getattr(self._inner, "batches_per_epoch", None)

    def ring_stats(self):
        """The pinned ring's counters: slots, (re)allocations and refills
        that had to wait for their previous copy."""
        ring = self._ring
        if ring is None:
            return {"slots": 0, "allocations": 0, "reuse_waits": 0}
        return {"slots": len(ring.slots), "allocations": ring.allocations,
                "reuse_waits": ring.reuse_waits}

    def timeline(self):
        """One dict a batch served, oldest first (the last TIMELINE_CAP),
        with its `epoch` and `position` in it and these
        `time.perf_counter()` readings: `loaded` (the
        loader's worker finished decoding it; None for another DataIter),
        `pull`/`pulled` (the stager asked the loader for it / got it),
        `ring` (it had a pinned slot; CUDA only), `host` (its arrays
        were in the slot), `staged` (it joined the staged queue),
        `issued` (next() enqueued its host-to-device copies),
        `asked`/`served` (the consumer's next() began / returned it);
        `copied` is whether its copy had completed on the device when it
        was served."""
        return [dict(m) for m in self._timeline]

    def reset(self):
        self._halt()
        self._inner.reset()
        self._consumed = 0
        self._warmup = self._k + 1
        if self._k > 0 and not self._closed:
            self._start()

    def set_epoch(self, epoch):
        if not hasattr(self._inner, "set_epoch"):
            return
        if self.epoch == int(epoch):
            return  # keep a mid-epoch resume position intact
        self._halt()
        self._inner.set_epoch(epoch)
        self._consumed = 0
        self._warmup = self._k + 1
        if self._k > 0 and not self._closed:
            self._start()

    def state_dict(self):
        state = dict(self._inner.state_dict())
        # the stager runs ahead of the consumer: checkpoint what was
        # HANDED OUT, so a restore replays exactly the unconsumed tail
        state["position"] = self._consumed
        return state

    def load_state_dict(self, state):
        self._halt()
        self._inner.load_state_dict(state)
        self._consumed = int(state["position"])
        self._warmup = self._k + 1
        if self._k > 0 and not self._closed:
            self._start()

    # --------------------------------------------------------- lifecycle
    def close(self, timeout=5.0):
        if self._closed:
            return
        self._closed = True
        self._halt(timeout)
        if hasattr(self._inner, "close"):
            self._inner.close()

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

    # ---------------------------------------------------------- DataIter
    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label
