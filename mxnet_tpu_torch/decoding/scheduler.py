"""Continuous-batching scheduler: the control loop of the decode tier.

One scheduler thread per decoder model drives a fixed-shape
`DecodeEngine` step loop. The decode batch is a ROLLING set: every
step the scheduler

  1. resolves per-sequence deadlines (mid-generation, not just at
     admission — a stuck client's sequence frees its pages promptly),
  2. admits waiting requests into free batch rows (prefill: one
     bucket-padded prompt pass that scatters K/V into fresh pages),
  3. grows each live sequence's page table by one page when its next
     token crosses a page boundary — preempting the lowest-priority
     (ties: most recently admitted) sequence when the pool is
     exhausted, never crashing,
  4. runs ONE fixed-shape decode step over the full (step_rows,
     pages_bucket) grid and streams each live row's token out.

Preemption drops a sequence's pages but keeps its token history; on
readmission the scheduler re-prefills prompt + generated-so-far and
the continuation picks up where it stopped — including sampled runs,
whose randomness is a pure function of (request seed, position) and so
replays exactly.

Two work-avoidance layers ride the same loop:

  * a `PrefixCache` (prefix.py) lets admission map full prompt pages
    already prefilled by live or recently-finished sequences instead
    of recomputing them; the uncached prompt tail rides the next
    decode step(s) as extra ragged rows (the merged step), or runs
    through the engine's tail-prefill shapes at admission (the split
    grid). Cached-but-unreferenced pages are evicted LRU under pool
    pressure BEFORE any live sequence is preempted.
  * with a draft model loaded, `_step` runs the engine's speculative
    propose+verify pair and can emit up to spec_k+1 tokens per target
    step (speculative.py).

`drain()` stops admission, lets live decodes finish for a while, then
hands each unfinished request off: its future fails with
RequestHandedOff carrying a JSON-ready resume record, which
`admit_resumed` on another scheduler accepts and continues.

Tokens reach callers through `DecodeFuture`: `result()` is the full
generated list, `stream()` returns a `TokenStream` iterating tokens as
steps complete. The stream OWNS the request: closing it cancels an
unfinished request so its pages return to the pool.

The loop thread sets its CUDA device before it drives the engine, so
every kernel of the step (the hand-written paged attention included)
launches on that thread's current stream of the engine's device.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time

import numpy as np
import torch

from ..serving.batcher import (DeadlineExceededError, ServerBusyError,
                               ServerClosedError, ServingError,
                               pick_bucket)
from ..telemetry import trace as _trace
from . import config as _cfg
from . import stats as _stats
from .blocks import SCRATCH_PAGE, PagePoolExhausted, pages_needed
from .engine import DecodeEngine
from .prefix import PrefixCache
from .sampling import SamplingParams
from .stats import DecodeStats

_DONE = object()


class RequestHandedOff(ServingError):
    """Raised into a request's future/stream when a draining decoder
    hands the request off instead of finishing it locally. `.state` is
    the JSON-ready resume record (prompt, tokens generated so far,
    sampling seed + position, remaining deadline) that `admit_resumed`
    on any other replica accepts — under counter-based sampling the
    continuation there is the uninterrupted run's, so a caller loses
    nothing but a little latency."""

    def __init__(self, state):
        super().__init__(
            "request handed off mid-decode; resume elsewhere with "
            "admit_resumed(exc.state)")
        self.state = state


class DecodeFuture:
    """Handle for one decode request: both a future and a stream.

    `result(timeout)` blocks for the COMPLETE generated token list
    (EOS excluded) or raises the request's failure. `stream(timeout)`
    returns a TokenStream iterating tokens as the scheduler emits
    them. `finish_reason` is "eos" | "max_tokens" | "length" |
    "cancelled" after completion. `cancel()` asks the scheduler to stop
    the request at its next sweep.
    """

    def __init__(self, trace_id=None):
        self.trace_id = trace_id
        self.finish_reason = None
        self._q = queue.Queue()
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._tokens = None
        self._exc = None

    # ---------------------------------------------- scheduler side
    def _emit(self, tok):
        self._q.put(int(tok))

    def _finish(self, tokens, reason):
        self.finish_reason = reason
        self._tokens = list(tokens)
        self._done.set()
        self._q.put(_DONE)

    def _fail(self, exc):
        self._exc = exc
        self._done.set()
        self._q.put(exc)

    # ------------------------------------------------- caller side
    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("decode request still running")
        if self._exc is not None:
            raise self._exc
        return list(self._tokens)

    def exception(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("decode request still running")
        return self._exc

    def cancel(self):
        """Request cancellation; returns True if the request was still
        running, False if it had already finished."""
        if self._done.is_set():
            return False
        self._cancel.set()
        return True

    def stream(self, timeout=None):
        """A TokenStream over generated tokens (close it to cancel)."""
        return TokenStream(self, timeout=timeout)


class TokenStream:
    """Iterator over one request's tokens that OWNS the request:
    `close()`, `with`-exit and garbage collection all cancel the
    underlying request if it has not finished. Iterating to the end
    makes close a no-op."""

    def __init__(self, future, timeout=None):
        self.future = future
        self._timeout = timeout

    def __iter__(self):
        return self

    def __next__(self):
        item = self.future._q.get(timeout=self._timeout)
        if item is _DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        """Cancel the request unless it already finished."""
        self.future.cancel()

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


class _Sequence:
    """Scheduler-internal state of one in-flight request."""

    __slots__ = ("prompt", "max_new", "priority", "deadline", "future",
                 "trace_id", "order", "sampling", "use_draft", "generated",
                 "table", "length", "last_token", "preempted",
                 "t_submit_pc", "pending_tail", "tail_meta")

    def __init__(self, prompt, max_new, priority, deadline, future,
                 trace_id, order, sampling, use_draft):
        self.prompt = list(prompt)
        self.max_new = max_new
        self.priority = priority
        self.deadline = deadline       # absolute monotonic, or None
        self.future = future
        self.trace_id = trace_id
        self.order = order             # admission tiebreak (FIFO)
        self.sampling = sampling       # SamplingParams (resolved)
        self.use_draft = use_draft     # speculative opt-in for this row
        self.generated = []
        self.table = None              # page ids while active
        self.length = 0                # tokens materialized in cache
        self.last_token = -1
        self.preempted = False
        self.t_submit_pc = _trace.now()
        # merged-step tail prefill: the uncached prompt tail still to be
        # fed through step() rows, and (t0, n_ctx, start, need_total,
        # n_matched) bookkeeping for the note_prefill/span record
        self.pending_tail = None
        self.tail_meta = None

    def context_tokens(self):
        """Tokens the KV cache must hold for this sequence: the prompt
        plus everything generated EXCEPT the newest token (whose K/V is
        appended by the next decode step)."""
        return self.prompt + self.generated[:-1] \
            if self.generated else list(self.prompt)


class ContinuousScheduler:
    """The rolling-batch control loop over one DecodeEngine."""

    def __init__(self, engine, stats, key, queue_cap=None,
                 max_tokens=None, eos_id=None):
        self.engine = engine
        self.stats = stats
        self.key = key
        self.queue_cap = queue_cap if queue_cap is not None \
            else _cfg.queue_cap()
        self.default_max_tokens = max_tokens if max_tokens is not None \
            else _cfg.max_tokens()
        self.eos_id = eos_id if eos_id is not None \
            else engine.cfg.eos_id
        # prompt-prefix page cache, salted by the engine's kv dtype so
        # its digests never match pages stored at another precision
        self.cache = PrefixCache(engine.allocator,
                                 kv_dtype=engine.kv_dtype) \
            if engine.prefix_cache_enabled else None
        self._cond = threading.Condition()
        self._waiting = []
        self._rows = [None] * engine.max_batch
        self._tail_plan = []           # (seq, chunk) for this step
        self._order = itertools.count()
        self._closed = False
        self._drain = True
        self._draining = False         # drain(): admission closed
        self._handoff = False          # leftovers hand off, not fail
        self._handoff_states = []      # loop/backstop-thread only
        self._thread = None

    # ------------------------------------------------------ public API
    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name=f"decoding-{self.key}", daemon=True)
        self._thread.start()
        return self

    def depth(self):
        """(waiting, active) — the stats view's queue-depth probe."""
        with self._cond:
            return (len(self._waiting),
                    sum(1 for s in self._rows if s is not None))

    def submit(self, prompt, max_new_tokens=None, priority=0,
               deadline_ms=None, sampling=None, seed=None, draft=None):
        """Enqueue one autoregressive request; returns a DecodeFuture.

        `priority`: higher values survive page-pool pressure longer.
        `deadline_ms` is end-to-end and checked EVERY step. `sampling`
        / `seed`: a SamplingParams (or None for the env defaults; `seed`
        overrides just the stream seed). Greedy (temperature <= 0)
        needs no seed. `draft`: per-request speculative opt-in/out;
        defaults to "on when a draft model is loaded".
        """
        prompt = [int(t) for t in prompt]
        sp = SamplingParams.resolve(sampling, seed)
        sp.validate(self.engine.cfg.vocab)
        if draft is None:
            use_draft = self.engine.spec_enabled
        else:
            use_draft = bool(draft)
            if use_draft and not self.engine.spec_enabled:
                raise ServingError(
                    "speculative decoding requested but no draft model "
                    "is loaded")
        if not prompt:
            raise ServingError("empty prompt")
        if any(t < 0 or t >= self.engine.cfg.vocab for t in prompt):
            raise ServingError("prompt token outside vocab")
        if len(prompt) > self.engine.max_context:
            raise ServingError(
                f"prompt of {len(prompt)} tokens exceeds the decode "
                f"context capacity {self.engine.max_context}")
        max_new = int(max_new_tokens) if max_new_tokens is not None \
            else self.default_max_tokens
        if max_new < 1:
            raise ServingError("max_new_tokens must be >= 1")
        tid = _trace.new_trace_id()
        with _trace.span("decoding.submit", trace_id=tid,
                         model=self.key):
            deadline = (time.monotonic() + deadline_ms / 1e3
                        if deadline_ms is not None else None)
            fut = DecodeFuture(tid)
            self._enqueue(lambda order: _Sequence(
                prompt, max_new, int(priority), deadline, fut, tid, order,
                sp, use_draft))
        return fut

    def _enqueue(self, make_seq):
        """Queue the sequence `make_seq(order)` builds, unless admission
        is closed or the queue is full."""
        with self._cond:
            if self._closed or self._draining:
                raise ServerClosedError("decoder is shut down")
            if len(self._waiting) >= self.queue_cap:
                self.stats.note_rejected()
                raise ServerBusyError(
                    f"decode queue full ({self.queue_cap}); "
                    "retry with backoff")
            self._waiting.append(make_seq(next(self._order)))
            self._cond.notify()
        self.stats.note_submitted()

    def admit_resumed(self, state):
        """Admit a request handed off by another scheduler's `drain()`.
        The resumed future's STREAM emits only NEW tokens — everything
        in state["generated"] was already delivered by the original
        replica — while `result()` returns the full list. Counter-based
        sampling (the token at position P is a pure function of the
        request seed and P) makes the continuation the uninterrupted
        run's; internally this rides the readmission path preemption
        uses."""
        prompt = [int(t) for t in state["prompt"]]
        generated = [int(t) for t in state.get("generated", ())]
        sp = SamplingParams.resolve(state.get("sampling"), None)
        sp.validate(self.engine.cfg.vocab)
        max_new = int(state["max_new_tokens"])
        if not prompt:
            raise ServingError("empty prompt in resume state")
        if any(t < 0 or t >= self.engine.cfg.vocab
               for t in prompt + generated):
            raise ServingError("resume state token outside vocab")
        if len(generated) >= max_new:
            raise ServingError(
                "resume state is already at max_new_tokens; nothing "
                "left to decode")
        if len(prompt) + len(generated) > self.engine.max_context:
            raise ServingError(
                "resume state exceeds the decode context capacity "
                f"{self.engine.max_context}")
        use_draft = bool(state.get("draft")) and self.engine.spec_enabled
        deadline_ms = state.get("deadline_ms")
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        tid = _trace.new_trace_id()
        fut = DecodeFuture(tid)

        def make_seq(order):
            seq = _Sequence(prompt, max_new, int(state.get("priority", 0)),
                            deadline, fut, tid, order, sp, use_draft)
            seq.generated = generated
            if generated:
                # the preemption-readmission contract: _admit restores
                # last_token without re-emitting the replayed token
                seq.preempted = True
                seq.last_token = generated[-1]
            return seq

        self._enqueue(make_seq)
        return fut

    def _handoff_state(self, seq, now=None):
        """JSON-ready resume record for one unfinished sequence (the
        payload of RequestHandedOff / input of admit_resumed)."""
        sp = seq.sampling
        st = {
            "prompt": list(seq.prompt),
            "generated": list(seq.generated),
            "max_new_tokens": seq.max_new,
            "priority": seq.priority,
            "position": len(seq.generated),
            "draft": bool(seq.use_draft),
            "sampling": {"temperature": sp.temperature,
                         "top_k": sp.top_k, "top_p": sp.top_p,
                         "seed": sp.seed},
        }
        if seq.deadline is not None:
            if now is None:
                now = time.monotonic()
            st["deadline_ms"] = max(0.0, (seq.deadline - now) * 1e3)
        return st

    def drain(self, timeout=30):
        """Graceful shutdown with zero request loss: stop admitting, let
        live decodes run to completion for up to `timeout` seconds, then
        hand off whatever is still unfinished — each leftover future
        resolves with RequestHandedOff carrying the resume record, and
        the list of records is returned so a control plane can re-admit
        them elsewhere. With timeout=0 everything in flight hands off
        immediately."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        while time.monotonic() < deadline:
            with self._cond:
                busy = bool(self._waiting) or any(
                    s is not None for s in self._rows)
            if not busy:
                break
            time.sleep(0.01)        # poll outside the lock
        with self._cond:
            self._closed = True
            self._drain = False
            self._handoff = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._fail_leftovers()
        if self.cache is not None:
            self.cache.release_all()
        return [dict(st) for st in self._handoff_states]

    def stop(self, drain=True, timeout=30):
        """Close admission; drain=True finishes in-flight sequences,
        drain=False fails them fast with ServerClosedError."""
        with self._cond:
            self._closed = True
            self._drain = drain
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._fail_leftovers()
        if self.cache is not None:
            # the loop is down: flush the cache's page refs so the
            # pool drains to empty (pages_in_use == 0 after close)
            self.cache.release_all()

    def _fail_leftovers(self):
        """Backstop against stranded futures: if the loop thread is
        down, any request still queued or rowed would otherwise wait
        forever. Sweep them into a terminal state — handoff records when
        draining, a ServerClosedError otherwise. No-op while the loop is
        alive (it owns the sweep then)."""
        if self._thread is not None and self._thread.is_alive():
            return
        with self._cond:
            leftovers = self._waiting[:]
            self._waiting.clear()
            leftovers.extend(s for s in self._rows if s is not None)
            handoff = self._handoff
        for s in leftovers:
            if s.future.done():
                continue
            if handoff:
                self._hand_off(s)
            else:
                self.stats.note_failed()
                self._resolve(s, exc=ServerClosedError("decoder stopped"))

    def _hand_off(self, seq, now=None):
        st = self._handoff_state(seq, now)
        self._handoff_states.append(st)
        self.stats.note_cancelled()
        self._resolve(seq, exc=RequestHandedOff(st))

    # ---------------------------------------------------- loop helpers
    def _active(self):
        return [s for s in self._rows if s is not None]

    def _resolve(self, seq, *, exc=None, reason=None):
        """Terminal transition: free pages, clear the row, settle the
        future exactly once."""
        if seq.table is not None:
            self.engine.allocator.free(seq.table)
            seq.table = None
        with self._cond:
            for row, s in enumerate(self._rows):
                if s is seq:
                    self._rows[row] = None
        if exc is not None:
            seq.future._fail(exc)
        else:
            self.stats.note_completed()
            seq.future._finish(seq.generated, reason)
        _trace.record_span(
            "decoding.reply", seq.trace_id, seq.t_submit_pc,
            _trace.now(),
            {"model": self.key,
             "outcome": reason or type(exc).__name__,
             "tokens": len(seq.generated)})

    def _preempt(self, seq):
        """Evict for pages: drop the sequence's pages but keep its token
        history; it re-prefills on readmission."""
        if seq.table is not None:
            self.engine.allocator.free(seq.table)
            seq.table = None
        seq.preempted = True
        # a merged-step tail in flight dies with the pages: readmission
        # re-plans the whole prompt (possibly re-matching the cache)
        seq.pending_tail = None
        seq.tail_meta = None
        with self._cond:
            for row, s in enumerate(self._rows):
                if s is seq:
                    self._rows[row] = None
            self._waiting.append(seq)
        self.stats.note_preempted()

    def _reclaim_one(self, requester):
        """Free pages by preempting ONE victim: the lowest-priority
        active sequence, ties broken most-recently-admitted-first. The
        requester itself is a candidate. Returns the victim, or None
        when nothing is preemptible."""
        victims = self._active()
        if requester is not None and requester.table is None:
            # an admission candidate competes at its own priority
            victims = [s for s in victims
                       if (s.priority, -s.order)
                       < (requester.priority, -requester.order)]
        if not victims:
            return None
        victim = min(victims, key=lambda s: (s.priority, -s.order))
        self._preempt(victim)
        return victim

    def _check_deadlines(self, now):
        """Per-step deadline resolution for both queued and active
        sequences."""
        with self._cond:
            expired = [s for s in self._waiting
                       if s.deadline is not None and now > s.deadline]
            for s in expired:
                self._waiting.remove(s)
        for s in self._active():
            if s.deadline is not None and now > s.deadline:
                expired.append(s)
        for s in expired:
            self.stats.note_expired()
            self._resolve(s, exc=DeadlineExceededError(
                f"deadline passed after {len(s.generated)} tokens"))

    def _check_cancelled(self):
        """Resolve requests whose future (or owning TokenStream) was
        cancelled: queued ones never admit, active ones free their
        pages now."""
        with self._cond:
            doomed = [s for s in self._waiting
                      if s.future._cancel.is_set()]
            for s in doomed:
                self._waiting.remove(s)
        for s in self._active():
            if s.future._cancel.is_set():
                doomed.append(s)
        for s in doomed:
            self.stats.note_cancelled()
            self._resolve(s, reason="cancelled")

    def _free_one_page(self, requester):
        """Make at least one page reclaimable, cheapest source first:
        evict a cached-but-idle prefix run before preempting any live
        sequence. Returns False when neither source can yield."""
        if self.cache is not None and self.cache.evict_lru():
            return True
        return self._reclaim_one(requester) is not None

    def _handle_token(self, seq, tok):
        """Post-step bookkeeping for one live row's emitted token."""
        if tok == self.eos_id:
            self._resolve(seq, reason="eos")
            return
        seq.generated.append(tok)
        seq.last_token = tok
        seq.future._emit(tok)
        if len(seq.generated) >= seq.max_new:
            self._resolve(seq, reason="max_tokens")
        elif seq.length >= self.engine.max_context:
            # no page can hold the next position: capacity stop
            self._resolve(seq, reason="length")

    def _finish_tail(self, seq, first_tok):
        """Merged-step tail completion: prefill stats, span record,
        cache publish and first-token handling, deferred to the decode
        step that wrote the final tail token (so cached pages are only
        published once actually filled)."""
        t0, n_ctx, start, need_total, n_matched = seq.tail_meta
        seq.tail_meta = None
        seq.pending_tail = None
        dt = _trace.now() - t0
        self.stats.note_prefill(n_ctx - start, dt,
                                readmission=seq.preempted)
        _trace.record_span(
            "decoding.prefill", seq.trace_id, t0, t0 + dt,
            {"model": self.key, "tokens": n_ctx,
             "cached_tokens": start, "pages": need_total,
             "pages_reused": n_matched,
             "readmission": seq.preempted, "merged": True})
        if self.cache is not None:
            P = self.engine.page_size
            n_full = len(seq.prompt) // P
            if n_full:
                self.cache.insert(seq.prompt[:n_full * P],
                                  seq.table[:n_full])
        was_preempted, seq.preempted = seq.preempted, False
        if was_preempted and seq.generated:
            # tail replay of a preempted run reproduces the token
            # already emitted; restore, don't re-emit (see _admit)
            seq.last_token = seq.generated[-1]
        else:
            self._handle_token(seq, first_tok)

    # -------------------------------------------------------- admission
    def _admit(self):
        """Fill free batch rows from the waiting queue in (priority,
        FIFO) order. Admission prefers free pages but will preempt
        strictly-lower-priority active sequences to make room.

        With the prefix cache on, admission first maps every full
        prompt page already cached for this token prefix (allocator
        `ref` — zero compute) and feeds ONLY the tail through the
        decode step's ragged rows. The match is capped one page short
        of the prompt so at least one tail token always runs, which
        also keeps cached pages out of every write range.
        """
        alloc = self.engine.allocator
        P = self.engine.page_size
        while None in self._rows:
            with self._cond:
                if not self._waiting:
                    return
                seq = min(self._waiting,
                          key=lambda s: (-s.priority, s.order))
                self._waiting.remove(seq)
            tokens = seq.context_tokens()
            need_total = pages_needed(len(tokens), P)
            matched, start = [], 0
            if self.cache is not None:
                matched, start = self.cache.match(
                    tokens, (len(tokens) - 1) // P)
                self.stats.note_prefix_reuse(len(matched))
            need = need_total - len(matched)
            ok = True
            while alloc.free_pages() < need:
                if not self._free_one_page(seq):
                    # nothing reclaimable below this priority: requeue
                    # and stop admitting (pages may free up later)
                    ok = False
                    break
            if not ok:
                if matched:
                    alloc.free(matched)
                with self._cond:
                    self._waiting.append(seq)
                return
            seq.table = matched + alloc.alloc(need)
            with self._cond:
                row = self._rows.index(None)
                self._rows[row] = seq
            t0 = _trace.now()
            if start and self.engine.merged_step_enabled:
                # merged-step deferral: the uncached tail rides the
                # next decode step(s) as ragged rows (_grow plans the
                # chunks, _step packs them); length stays at the cached
                # prefix until those rows actually write
                seq.pending_tail = list(tokens[start:])
                seq.length = start
                seq.tail_meta = (t0, len(tokens), start, need_total,
                                 len(matched))
                continue
            sp = seq.sampling
            first = self.engine.prefill(
                tokens, seq.table, start=start, seed=sp.seed,
                temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p)
            dt = _trace.now() - t0
            self.stats.note_prefill(len(tokens) - start, dt,
                                    readmission=seq.preempted)
            _trace.record_span(
                "decoding.prefill", seq.trace_id, t0, t0 + dt,
                {"model": self.key, "tokens": len(tokens),
                 "cached_tokens": start, "pages": need_total,
                 "pages_reused": len(matched),
                 "readmission": seq.preempted})
            seq.length = len(tokens)
            if self.cache is not None:
                # publish this prompt's full pages (existing runs keep
                # their pages; only the new suffix takes cache refs)
                n_full = len(seq.prompt) // P
                if n_full:
                    self.cache.insert(seq.prompt[:n_full * P],
                                      seq.table[:n_full])
            was_preempted, seq.preempted = seq.preempted, False
            if was_preempted and seq.generated:
                # the re-prefill reproduces the token already emitted
                # (sampled streams are (seed, position)-pure); restore,
                # don't re-emit
                seq.last_token = seq.generated[-1]
            else:
                self._handle_token(seq, int(first))

    # ------------------------------------------------------------ growth
    def _make_range_writable(self, seq, first, last):
        """Break COW aliases on table[first..last] (evicting cached
        pages, then preempting `seq`, when a copy needs a page).
        Returns False when `seq` was preempted."""
        alloc = self.engine.allocator
        for idx in range(first, last + 1):
            page, copy_from = None, None
            while seq.table is not None:
                try:
                    page, copy_from = alloc.make_writable(seq.table, idx)
                    break
                except PagePoolExhausted:
                    if self.cache is not None and self.cache.evict_lru():
                        continue
                    self._preempt(seq)
            if seq.table is None or page is None:
                return False
            if copy_from is not None:
                self.engine.copy_page(copy_from, page)
        return True

    def _extend_table(self, seq, need):
        """Grow seq.table to `need` pages (evicting, then preempting,
        under pressure). Returns False when it could not."""
        alloc = self.engine.allocator
        while seq.table is not None and len(seq.table) < need:
            try:
                seq.table.extend(alloc.alloc(1))
            except PagePoolExhausted:
                if self.cache is not None and self.cache.evict_lru():
                    continue
                if self._reclaim_one(None) is None:
                    break
        return seq.table is not None and len(seq.table) >= need

    def _grow(self):
        """Before each step, back every live row's WHOLE write range —
        positions length..length+K, K = spec_k in speculative mode, else
        0 — with exclusively-owned pages (rejected speculative entries
        land in owned pages, so rollback by truncation never corrupts a
        shared page), and plan this step's merged tail rows: split the
        tail_budget extra rows across sequences still holding a pending
        prompt tail, sizing each one's page table for the chunk it will
        write."""
        P = self.engine.page_size
        cap = self.engine.max_context
        k = self.engine.spec_k if self.engine.spec_enabled else 0
        for seq in self._active():
            if seq.table is None or seq.pending_tail:
                continue    # tail seqs: write range planned below
            cover = min(seq.length + k + 1, cap)
            if not self._extend_table(seq, pages_needed(cover, P)):
                continue    # preempted itself; back in the queue
            self._make_range_writable(
                seq, seq.length // P,
                min((cover - 1) // P, len(seq.table) - 1))
        self._tail_plan = []
        if not self.engine.merged_step_enabled:
            return
        budget = self.engine.tail_budget
        for seq in self._active():
            if budget <= 0:
                break
            if seq.table is None or not seq.pending_tail:
                continue
            chunk = min(len(seq.pending_tail), budget)
            cover = min(seq.length + chunk, cap)
            if not self._extend_table(seq, pages_needed(cover, P)):
                continue
            if self._make_range_writable(
                    seq, seq.length // P,
                    min((cover - 1) // P, len(seq.table) - 1)):
                self._tail_plan.append((seq, chunk))
                budget -= chunk

    # -------------------------------------------------------------- step
    def _step(self):
        engine = self.engine
        live = [(row, s) for row, s in enumerate(self._rows)
                if s is not None]
        if not live:
            return
        b = engine.max_batch
        r = engine.step_rows        # == b + tail_budget when merged
        spec = engine.spec_enabled
        k = engine.spec_k if spec else 0
        # _grow already sized every table for the full write range;
        # span over table lengths keeps the bucket consistent with it
        span = max(len(s.table) for _, s in live)
        bucket = pick_bucket(span, engine.page_buckets)
        tokens = np.zeros((r,), np.int32)
        table = np.full((r, bucket), SCRATCH_PAGE, np.int32)
        lengths = np.zeros((r,), np.int32)
        active = np.zeros((r,), bool)
        use_draft = np.zeros((r,), bool)
        seeds = np.zeros((r,), np.uint32)
        temps = np.zeros((r,), np.float32)
        top_ks = np.zeros((r,), np.int32)
        top_ps = np.ones((r,), np.float32)

        def put(row, seq):
            sp = seq.sampling
            active[row] = True
            seeds[row] = sp.seed & 0xFFFFFFFF
            temps[row] = sp.temperature
            top_ks[row] = sp.top_k
            top_ps[row] = sp.top_p

        for row, s in live:
            if s.pending_tail:
                continue    # fed through the ragged tail rows below
            tokens[row] = s.last_token
            table[row, :len(s.table)] = s.table
            lengths[row] = s.length
            use_draft[row] = s.use_draft
            put(row, s)
        # ragged rows b..r-1: planned prompt-tail chunks ride the same
        # fixed-shape step. Row j of a chunk holds the prompt token at
        # absolute position lengths[row]; the kernel's per-row length
        # masking gives intra-chunk causality, and the chunk's LAST row
        # yields the sequence's first token at its true position.
        tail_rows = []
        next_row = b
        for seq, chunk in self._tail_plan:
            if seq.table is None or not seq.pending_tail \
                    or seq.future.done():
                continue    # resolved/preempted after planning
            chunk = min(chunk, len(seq.pending_tail))
            for j in range(chunk):
                row = next_row
                next_row += 1
                tokens[row] = seq.pending_tail[j]
                table[row, :len(seq.table)] = seq.table
                lengths[row] = seq.length + j
                put(row, seq)
            tail_rows.append((seq, next_row - 1, chunk))
        t0 = _trace.now()
        samp = (seeds, temps, top_ks, top_ps)
        if spec:
            out, n_emit = engine.spec_step(tokens, table, lengths, active,
                                           use_draft, *samp)
        else:
            out = engine.step(tokens, table, lengths, active, *samp)
        dt = _trace.now() - t0
        emitted = 0
        if spec:
            for row, s in live:
                n = int(n_emit[row])
                if s.use_draft:
                    self.stats.note_spec(k, n - 1)
                for j in range(n):
                    if s.table is None or s.future.done():
                        break   # resolved mid-run (eos/max_tokens)
                    s.length += 1
                    emitted += 1
                    self._handle_token(s, int(out[row, j]))
        else:
            for row, s in live:
                if s.pending_tail:
                    continue    # decode row was inactive this step
                s.length += 1
                emitted += 1
                self._handle_token(s, int(out[row]))
            for seq, last_row, chunk in tail_rows:
                if seq.table is None or seq.future.done():
                    continue
                seq.length += chunk
                del seq.pending_tail[:chunk]
                if not seq.pending_tail:
                    # tail tokens are prefill work, not emitted tokens:
                    # counted via note_prefill in _finish_tail
                    self._finish_tail(seq, int(out[last_row]))
        self.stats.note_step(emitted, dt)
        _trace.record_span(
            "decoding.step", None, t0, t0 + dt,
            {"trace_ids": tuple(s.trace_id for _, s in live),
             "model": self.key, "live": len(live), "bucket": bucket,
             "tokens": emitted})
        self.stats.note_pool()
        if engine._guard and self.stats.steps % 16 == 0:
            # interval drain of the numerics guard (one fetch per 16
            # steps)
            for nf, clips in engine.drain_guard():
                if nf:
                    self.stats.note_nonfinite(nf)
                if clips:
                    self.stats.note_quant_clips(clips)

    # -------------------------------------------------------------- loop
    def _loop(self):
        if self.engine.device.type == "cuda":
            # device and stream are per thread: launch everything of
            # this loop on the engine's device
            torch.cuda.set_device(self.engine.device)
        while True:
            with self._cond:
                while (not self._closed and not self._waiting
                       and not any(self._rows)):
                    # bounded wait so queued-only deadline expiry is
                    # still timely under an idle engine
                    self._cond.wait(0.05)
                if self._closed:
                    if not self._drain:
                        doomed = self._waiting[:]
                        self._waiting.clear()
                    elif not self._waiting and not any(self._rows):
                        return
            if self._closed and not self._drain:
                doomed.extend(self._active())
                now = time.monotonic()
                for s in doomed:
                    if self._handoff:
                        # drain() timed out with work in flight: every
                        # leftover resolves with its resume record
                        self._hand_off(s, now)
                    else:
                        self.stats.note_failed()
                        self._resolve(s, exc=ServerClosedError(
                            "decoder stopped"))
                return
            try:
                self._check_deadlines(time.monotonic())
                self._check_cancelled()
                self._admit()
                self._grow()
                self._step()
            except Exception as exc:  # never kill the loop silently
                for s in self._active():
                    self.stats.note_failed()
                    self._resolve(s, exc=exc)
                with self._cond:
                    bail = self._closed
                    stranded = self._waiting[:] if bail else []
                    if bail:
                        self._waiting.clear()
                if bail:
                    # shutting down on a persistently-raising engine:
                    # fail the queue and exit
                    for s in stranded:
                        self.stats.note_failed()
                        self._resolve(s, exc=exc)
                    return


class DecodedModel:
    """One loaded decoder: engine + scheduler + stats, the decode-tier
    serving entry point. Runs on the CUDA device unless `device` names
    another (the tests pass device="cpu"); with no CUDA device and no
    explicit device it raises.

        model = DecodedModel("lm", 1, init_decoder_params(cfg), cfg,
                             max_batch=8, num_pages=1024)
        for tok in model.stream(prompt_ids, max_new_tokens=64,
                                sampling=SamplingParams(
                                    temperature=0.8, top_k=40,
                                    top_p=0.95, seed=7)): ...

    `draft`: a draft model's params (a flat dict or a Decoder, with
    `draft_cfg`), the string "self" (the target drafts for itself), or
    None to read MXNET_DECODE_SPEC_DRAFT; `spec_k` draft tokens a step
    (MXNET_DECODE_SPEC_K).
    """

    def __init__(self, name, version, params, cfg, *, max_batch=None,
                 page_size=None, num_pages=None, page_buckets=None,
                 ring_prefill=None, queue_cap=None, max_tokens=None,
                 warmup=True, draft=None, draft_cfg=None, spec_k=None,
                 prefix_cache=None, merged_step=None, kv_dtype=None,
                 device=None):
        self.name = name
        self.version = int(version)
        self.cfg = cfg
        if draft is None and _cfg.spec_draft():
            draft = _cfg.spec_draft()
        draft_params = None
        if isinstance(draft, str):
            if draft == "self":
                draft_params, draft_cfg = params, cfg
            elif draft:
                raise ServingError(
                    f"unknown draft spec {draft!r} (expected 'self' or a "
                    "params dict)")
        elif draft is not None:
            draft_params = draft
            draft_cfg = draft_cfg if draft_cfg is not None else cfg
        self.engine = DecodeEngine(
            params, cfg, max_batch=max_batch, page_size=page_size,
            num_pages=num_pages, page_buckets=page_buckets,
            ring_prefill=ring_prefill, draft_params=draft_params,
            draft_cfg=draft_cfg, spec_k=spec_k, prefix_cache=prefix_cache,
            merged_step=merged_step, kv_dtype=kv_dtype, device=device)
        self.stats = DecodeStats(key=self.key, traces_fn=self.engine.traces,
                                 pool_fn=self.engine.pool_stats)
        self.scheduler = ContinuousScheduler(
            self.engine, self.stats, self.key, queue_cap=queue_cap,
            max_tokens=max_tokens)
        self.stats._depth_fn = self.scheduler.depth
        if self.scheduler.cache is not None:
            self.stats._prefix_fn = self.scheduler.cache.stats
        _stats._register(self.key, self.stats)
        self._started = False
        if warmup:
            self.warmup()

    @property
    def key(self):
        return f"{self.name}:{self.version}"

    def warmup(self):
        """Visit the full decode grid (capturing its graphs on CUDA) and
        latch the trace floor; the scheduler thread starts only once the
        model is warm."""
        self.engine.warmup()
        self.stats.mark_warmup_done()
        if not self._started:
            self.scheduler.start()
            self._started = True
        return self

    # -------------------------------------------------------- data path
    def submit(self, prompt, max_new_tokens=None, priority=0,
               deadline_ms=None, sampling=None, seed=None, draft=None):
        return self.scheduler.submit(prompt,
                                     max_new_tokens=max_new_tokens,
                                     priority=priority,
                                     deadline_ms=deadline_ms,
                                     sampling=sampling, seed=seed,
                                     draft=draft)

    def generate(self, prompt, max_new_tokens=None, priority=0,
                 deadline_ms=None, timeout=None, sampling=None, seed=None,
                 draft=None):
        """Sync decode: the full generated token list."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           priority=priority, deadline_ms=deadline_ms,
                           sampling=sampling, seed=seed,
                           draft=draft).result(timeout)

    def stream(self, prompt, max_new_tokens=None, priority=0,
               deadline_ms=None, timeout=None, sampling=None, seed=None,
               draft=None):
        """Streaming decode: a TokenStream yielding tokens as steps
        complete. Close it (or exit its `with` block) to cancel."""
        fut = self.submit(prompt, max_new_tokens=max_new_tokens,
                          priority=priority, deadline_ms=deadline_ms,
                          sampling=sampling, seed=seed, draft=draft)
        return fut.stream(timeout=timeout)

    def admit_resumed(self, state):
        """Admit a handed-off request (ContinuousScheduler.admit_resumed):
        returns a DecodeFuture whose stream emits only the tokens not yet
        delivered elsewhere."""
        return self.scheduler.admit_resumed(state)

    def drain(self, timeout=30):
        """Stop admitting, finish live decodes (up to `timeout` s), hand
        off the rest; returns the handoff records."""
        try:
            return self.scheduler.drain(timeout=timeout)
        finally:
            _stats._unregister(self.key, self.stats)

    def close(self, drain=True, timeout=30):
        self.scheduler.stop(drain=drain, timeout=timeout)
        _stats._unregister(self.key, self.stats)
