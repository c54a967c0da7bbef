"""ModelServer: the serving front door: admission, batching workers,
deadlines, sync and async APIs. The counterpart of
mxnet_tpu/serving/server.py.

Request lifecycle:

  submit() -- admission --> DynamicBatcher.put --> per-model worker
     |         (queue cap ->   (bounded FIFO per     thread: flush ->
     |          ServerBusyError) length bucket)      pad/stack ->
     |                                               Predictor.forward
     +-- returns concurrent.futures.Future <-------- unpad + set_result

One worker thread per model keeps each bucket's Predictor on one thread
(an Executor is not safe to share), and makes the model's card its
current device. The padded batch is copied to the card synchronously
from the host buffer `BucketSpec.assemble` built, so the next
assembly cannot overwrite a batch still in flight. Submit threads keep
feeding the queue while a batch runs. `predict()` is submit().result().
Deadlines are checked at admission and again at flush time (a request
whose deadline passed while queued raises DeadlineExceededError instead
of taking a batch slot).

Decoders (`load_decoder`) share the name/version namespace; their lane
is the DecodedModel's own scheduler thread, and traffic goes through
`submit_decode` / `generate` / `stream` / `admit_resumed`.

Shutdown: `stop()` closes admission, drains pending groups through the
workers (drain=True, default) or fails them with ServerClosedError
(drain=False), then joins the threads; `drain()` hands unfinished
decodes off. Context-manager friendly.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future

from ..telemetry import trace as _trace
from ..telemetry import http as _thttp
from ..telemetry import registry as _treg
from .batcher import (DynamicBatcher, DeadlineExceededError,
                      ServerClosedError, ServingError, _Request)
from .registry import ModelRegistry
from . import config as _cfg

# end-to-end request latency (enqueue -> reply), labelled per model —
# the native-histogram companion of ServingStats' p50/p95/p99 snapshot
_LATENCY_MS = _treg.histogram(
    "mxnet_tpu_serving_request_latency_ms",
    "End-to-end serving request latency (enqueue to reply)")


class _ModelLane:
    """One model's batcher + worker thread."""

    def __init__(self, model, max_wait_us, queue_cap):
        self.model = model
        self.batcher = DynamicBatcher(model.spec, max_wait_us,
                                      queue_cap)
        model.stats._queue_depth_fn = self.batcher.depth
        self.thread = None

    def start(self, loop):
        self.thread = threading.Thread(
            target=loop, args=(self,),
            name=f"serving-{self.model.key}", daemon=True)
        self.thread.start()


class ModelServer:
    """Dynamic-batching inference server over a ModelRegistry."""

    def __init__(self, registry=None, max_batch=None, max_wait_us=None,
                 queue_cap=None):
        self.registry = registry or ModelRegistry()
        self._max_batch = max_batch
        self._max_wait_us = (max_wait_us if max_wait_us is not None
                             else _cfg.max_wait_us())
        self._queue_cap = (queue_cap if queue_cap is not None
                           else _cfg.queue_cap())
        self._lanes = {}
        self._decoders = {}
        self._lock = threading.Lock()
        self._closed = False
        # opt-in live introspection: with MXNET_TELEMETRY_PORT set this
        # server answers /metrics, /statusz, /healthz while serving
        _thttp.maybe_start_exporter()

    # ------------------------------------------------------ model mgmt
    def load(self, name, symbol_json, param_data, input_specs,
             **kwargs):
        """Registry load + lane start: the model is ready for traffic
        (warmed: every bucket pre-traced) when this returns."""
        kwargs.setdefault("max_batch", self._max_batch)
        model = self.registry.load(name, symbol_json, param_data,
                                   input_specs, **kwargs)
        self._start_lane(model)
        return model

    def load_checkpoint(self, name, prefix, epoch, input_specs,
                        **kwargs):
        kwargs.setdefault("max_batch", self._max_batch)
        model = self.registry.load_checkpoint(name, prefix, epoch,
                                              input_specs, **kwargs)
        self._start_lane(model)
        return model

    def load_decoder(self, name, params, decoder_cfg, **kwargs):
        """Load + warm a continuous-batching decoder
        (decoding.DecodedModel). Its lane is the scheduler thread inside
        the model (no DynamicBatcher), and traffic goes through
        submit_decode/generate/stream, not submit/predict. Warm (every
        prefill + decode cell visited) on return."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("server is stopped")
        model = self.registry.load_decoder(name, params, decoder_cfg,
                                           **kwargs)
        with self._lock:
            self._decoders[model.key] = model
        return model

    def load_bundle(self, path, name=None, version=None, warmup=True):
        """Restore a serving bundle (serving.save_bundle) into this
        server and attach its lane (a decoder's lane is its own
        scheduler thread)."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("server is stopped")
        model = self.registry.load_bundle(path, name=name,
                                          version=version,
                                          warmup=warmup)
        if hasattr(model, "spec"):
            self._start_lane(model)
        else:
            with self._lock:
                self._decoders[model.key] = model
        return model

    def serve(self, model):
        """Attach a lane to an already-registered ServedModel (for a
        registry shared across servers)."""
        self._start_lane(model)
        return model

    def _start_lane(self, model):
        with self._lock:
            if self._closed:
                raise ServerClosedError("server is stopped")
            if model.key in self._lanes:
                return
            lane = _ModelLane(model, self._max_wait_us,
                              self._queue_cap)
            self._lanes[model.key] = lane
        lane.start(self._worker_loop)

    def unload(self, name, version=None):
        removed = self.registry.unload(name, version=version)
        for model in removed:
            with self._lock:
                lane = self._lanes.pop(model.key, None)
                self._decoders.pop(model.key, None)
            if lane is not None:
                lane.batcher.close()
                lane.thread.join(timeout=30)
        return removed

    # ------------------------------------------------------- data path
    def submit(self, name, inputs, version=None, deadline_ms=None):
        """Async inference: returns a Future of the request's output
        list (one numpy array per model output, padding sliced off).
        Raises ServerBusyError synchronously when the queue is full.

        The Future carries the request's correlation id as
        `fut.trace_id`; `telemetry.spans_for_trace(fut.trace_id)`
        reconstructs the request's path submit -> enqueue ->
        batch_flush -> execute -> reply."""
        tid = _trace.new_trace_id()
        with _trace.span("serving.submit", trace_id=tid, model=name):
            model = self.registry.get(name, version=version)
            if not hasattr(model, "spec"):   # a DecodedModel
                raise ServingError(
                    f"{model.key} is a decoder model; use "
                    "submit_decode/generate/stream")
            with self._lock:
                lane = self._lanes.get(model.key)
                closed = self._closed
            if lane is None or closed:
                raise ServerClosedError(
                    f"no active lane for {model.key} (server stopped "
                    "or model not served)")
            stats = model.stats
            stats.note_submitted()
            length = model.spec.request_length(inputs)
            bucket = model.spec.length_bucket(length)
            deadline = (time.monotonic() + deadline_ms / 1e3
                        if deadline_ms is not None else None)
            fut = Future()
            fut.trace_id = tid
            req = _Request(inputs, fut, deadline, length, bucket,
                           trace_id=tid)
            try:
                lane.batcher.put(req)
            except Exception as exc:
                stats.note_rejected()
                raise exc
        return fut

    def predict(self, name, inputs, version=None, deadline_ms=None,
                timeout=None):
        """Sync inference (the Predictor.forward ergonomics, batched
        under the hood)."""
        fut = self.submit(name, inputs, version=version,
                          deadline_ms=deadline_ms)
        return fut.result(timeout=timeout)

    # ----------------------------------------------- decode data path
    def _decoder(self, name, version=None):
        model = self.registry.get(name, version=version)
        if hasattr(model, "spec"):
            raise ServingError(
                f"{model.key} is a one-shot model; use submit/predict")
        return model

    def submit_decode(self, name, prompt, version=None,
                      max_new_tokens=None, priority=0,
                      deadline_ms=None, sampling=None, seed=None,
                      draft=None):
        """Async autoregressive decode: returns a DecodeFuture —
        `result()` for the full token list, `stream()` to iterate
        tokens as continuous-batching steps emit them. `deadline_ms`
        is enforced EVERY decode step, not only at admission.
        `sampling` is a decoding.SamplingParams (None = env-default
        greedy); `seed` overrides just its stream seed; `draft`
        opts this request in/out of speculative decoding (None =
        on when the decoder has a draft model)."""
        return self._decoder(name, version).submit(
            prompt, max_new_tokens=max_new_tokens, priority=priority,
            deadline_ms=deadline_ms, sampling=sampling, seed=seed,
            draft=draft)

    def generate(self, name, prompt, version=None, max_new_tokens=None,
                 priority=0, deadline_ms=None, timeout=None,
                 sampling=None, seed=None, draft=None):
        """Sync decode: the complete generated token list."""
        return self.submit_decode(
            name, prompt, version=version,
            max_new_tokens=max_new_tokens, priority=priority,
            deadline_ms=deadline_ms, sampling=sampling, seed=seed,
            draft=draft).result(timeout)

    def stream(self, name, prompt, version=None, max_new_tokens=None,
               priority=0, deadline_ms=None, timeout=None,
               sampling=None, seed=None, draft=None):
        """Streaming decode: a TokenStream of per-step tokens; close
        it (or exit its `with` block) to cancel the request and free
        its KV pages early."""
        return self.submit_decode(
            name, prompt, version=version,
            max_new_tokens=max_new_tokens, priority=priority,
            deadline_ms=deadline_ms, sampling=sampling, seed=seed,
            draft=draft).stream(timeout=timeout)

    def admit_resumed(self, name, state, version=None):
        """Admit a handed-off decode request (a record from `drain()`
        on another server/replica, or one the fleet router rebuilt
        after a replica died). Returns a DecodeFuture whose stream
        emits only tokens not yet delivered elsewhere; counter-based
        sampling makes the continuation bit-identical."""
        return self._decoder(name, version).admit_resumed(state)

    # ---------------------------------------------------------- worker
    def _worker_loop(self, lane):
        model, batcher = lane.model, lane.batcher
        spec, stats = model.spec, model.stats
        model.bind_thread()
        while True:
            group = batcher.next_batch()
            # deadline sweep every wake-up, not only at this group's
            # flush: requests in OTHER buckets whose deadline passed
            # while queued resolve promptly and free their queue slots
            now = time.monotonic()
            for r in batcher.pop_expired(now):
                stats.note_expired()
                r.future.set_exception(DeadlineExceededError(
                    "deadline passed while queued "
                    f"(waited {(now - r.t_enqueue) * 1e3:.1f} ms)"))
                _trace.record_span("serving.enqueue", r.trace_id,
                                   r.t_enqueue_pc, _trace.now(),
                                   {"model": model.key,
                                    "outcome": "expired"})
            if group is None:
                if batcher._closed and batcher.depth() == 0:
                    return
                continue
            t_flush = _trace.now()
            live = []
            for r in group:
                if r.expired(now):
                    stats.note_expired()
                    r.future.set_exception(DeadlineExceededError(
                        "deadline passed while queued "
                        f"(waited {(now - r.t_enqueue) * 1e3:.1f} ms)"))
                else:
                    live.append(r)
                # queue-residency span closes at flush time, expired
                # requests included (their wait is the story)
                _trace.record_span("serving.enqueue", r.trace_id,
                                   r.t_enqueue_pc, t_flush,
                                   {"model": model.key})
            if not live:
                continue
            for row, r in enumerate(live):
                r.row = row
            # batch-level spans carry every member's correlation id so
            # spans_for_trace(tid) finds them via the trace_ids attr
            tids = tuple(r.trace_id for r in live)
            try:
                feed, batch, lb, real, padded = spec.assemble(live)
                t_assembled = _trace.now()
                _trace.record_span(
                    "serving.batch_flush", None, t_flush, t_assembled,
                    {"trace_ids": tids, "model": model.key,
                     "live": len(live), "batch": batch, "length": lb})
                with _trace.span("serving.execute", model=model.key,
                                 batch=batch, trace_ids=tids):
                    outs = model.infer(feed, batch, lb)
                per_req = spec.disassemble(outs, live, lb)
            except Exception as exc:
                stats.note_failed(len(live))
                for r in live:
                    if not r.future.set_running_or_notify_cancel():
                        continue
                    r.future.set_exception(exc)
                continue
            stats.note_batch(len(live), batch,
                             real_elems=real, padded_elems=padded)
            done = time.monotonic()
            for r, outputs in zip(live, per_req):
                stats.note_completed(done - r.t_enqueue, now=done)
                t_r0 = _trace.now()
                if r.future.set_running_or_notify_cancel():
                    r.future.set_result(outputs)
                t_r1 = _trace.now()
                _trace.record_span("serving.reply", r.trace_id,
                                   t_r0, t_r1, {"model": model.key})
                _LATENCY_MS.observe((t_r1 - r.t_enqueue_pc) * 1e3,
                                    model=model.key)

    # -------------------------------------------------------- lifecycle
    def drain(self, timeout=30):
        """Zero-loss shutdown: stop admitting, let live work finish
        for up to `timeout` seconds per decoder, hand off the rest.
        Returns {decoder_key: [handoff records]} — every unfinished
        decode request's resume state (its future resolves with
        RequestHandedOff). One-shot lanes have no mid-request state
        to hand off; their queues drain normally."""
        with self._lock:
            self._closed = True
            lanes = list(self._lanes.values())
            decoders = list(self._decoders.values())
        handoffs = {}
        for dm in decoders:
            states = dm.drain(timeout=timeout)
            if states:
                handoffs[dm.key] = states
        for lane in lanes:
            lane.batcher.close()
        for lane in lanes:
            if lane.thread is not None:
                lane.thread.join(timeout=timeout)
        return handoffs

    def stop(self, drain=True, timeout=30):
        """Close admission and shut the workers down. drain=True lets
        queued requests complete; drain=False fails them fast."""
        with self._lock:
            self._closed = True
            lanes = list(self._lanes.values())
            decoders = list(self._decoders.values())
        for dm in decoders:
            dm.close(drain=drain, timeout=timeout)
        for lane in lanes:
            if not drain:
                # fail pending before the worker can flush them; the
                # batcher drains under its own cond, futures fail here
                # outside it (a future callback may take other locks)
                for r in lane.batcher.drain_pending():
                    r.future.set_exception(
                        ServerClosedError("server stopped"))
            lane.batcher.close()
        for lane in lanes:
            if lane.thread is not None:
                lane.thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
