"""FleetRouter: the multi-replica serving control plane
(mxnet_tpu/fleet/router.py).

One router process owns N replica workers (each a fresh process that
restored the SAME serving bundle — zero traces/compiles per replica —
on the router's context: the card unless `ctx=mx.cpu()` or a
`with mx.cpu():` scope names the host) and spreads
`submit`/`generate`/`stream` across them:

  routing     prefix-affinity first: hash the prompt's page-aligned
              prefix (`page_digests`, same page size as the paged KV
              cache) and prefer the replica whose advertised radix
              cache covers the longest run — every covered page is
              prefill that replica skips. Fall back to least-loaded
              (heartbeat depth vs the router's own in-flight count,
              whichever is worse); policy="random" exists for the
              A/B benchmark arm.
  liveness    replicas heartbeat depth + stats + cache digests; one
              silent for 5 periods is retired and its in-flight
              requests are REBUILT from the router's own token record
              (prompt + tokens relayed so far + sampling seed) and
              re-admitted elsewhere — bit-identical under
              counter-based sampling, so a SIGKILL mid-stream loses
              nothing.
  drain       shrink always goes through drain: the victim stops
              admitting, finishes or hands off live decodes (handoff
              frames re-route through `admit_resumed`), then exits.
              A drain that blows its deadline is escalated to a kill,
              which lands in the same rebuild path — still zero-loss.
  autoscale   an optional Autoscaler turns heartbeat queue depths
              into spawn/drain decisions (hysteresis band + patience,
              so no flapping).

The router is the ORDER of record for every request: it accumulates
each stream's tokens as they relay, so `done` resolution, replica
death, and handoff re-admission all work from the router's own copy
and a replica is never trusted to remember anything across its own
death.

Locking: `self._lock` guards only the handle/pending dict membership
(plain dict ops — no socket, sleep, or join ever runs under it);
per-handle fields are single-writer (that handle's reader thread or
the monitor after retirement); AffinityIndex/FleetStats/DrainLedger
take their own leaf locks. Retirement races (monitor staleness vs
reader EOF) are settled by dict ownership: whoever pops the handle
retires it.
"""
from __future__ import annotations

import json
import os
import queue
import random
import socket
import subprocess
import sys
import threading
import time

from ..serving.batcher import (DeadlineExceededError, ServerBusyError,
                               ServerClosedError, ServingError)
from ..serving.bundle import MANIFEST
from ..decoding.scheduler import TokenStream, _DONE
from . import config as _cfg
from .affinity import AffinityIndex
from .autoscale import Autoscaler
from .drain import DrainLedger, check_handoff_state
from .stats import FleetStats, _register, _unregister
from .wire import Channel

_STALE_HEARTBEATS = 5          # silent this many periods -> dead
_ACCEPT_TIMEOUT_S = 0.2


def replica_command(bundle, port, rid, heartbeat_ms, ctx):
    """The argv of one replica process (the router's default spawn);
    `ctx` becomes its `--ctx`."""
    where = "cpu" if ctx.device_type == "cpu" else f"gpu:{ctx.device_id}"
    return [sys.executable, "-m", "mxnet_tpu_torch.fleet.replica",
            "--bundle", bundle,
            "--connect", f"127.0.0.1:{port}",
            "--id", rid,
            "--heartbeat-ms", str(int(heartbeat_ms)),
            "--ctx", where]


class FleetFuture:
    """Router-side future of one fleet request — the DecodeFuture
    surface (result / exception / done / cancel / stream) without a
    scheduler behind it: the reader threads resolve it from wire
    frames, and `stream()` reuses the decoding TokenStream (closing
    the stream cancels the request fleet-wide)."""

    def __init__(self, mid, cancel_cb=None):
        self.mid = mid
        self.finish_reason = None
        self._q = queue.Queue()
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._cancel_cb = cancel_cb
        self._value = None
        self._exc = None

    # ---------------------------------------------- router side
    def _emit(self, tok):
        self._q.put(int(tok))

    def _finish(self, value, reason=None):
        self.finish_reason = reason
        self._value = value
        self._done.set()
        self._q.put(_DONE)

    def _fail(self, exc):
        self._exc = exc
        self._done.set()
        self._q.put(exc)

    # ---------------------------------------------- caller side
    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("fleet request still running")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("fleet request still running")
        return self._exc

    def cancel(self):
        if self._done.is_set():
            return False
        self._cancel.set()
        if self._cancel_cb is not None:
            self._cancel_cb(self)
        return True

    def stream(self, timeout=None):
        return TokenStream(self, timeout=timeout)


class ReplicaHandle:
    """Router-side record of one live replica. Fields are
    single-writer: the handle's reader thread owns hb/last_hb, the
    control path owns draining (idempotent True-only), membership in
    the router's handle dict is the liveness bit."""

    __slots__ = ("id", "chan", "proc", "hello", "hb", "last_hb",
                 "draining", "reader")

    def __init__(self, rid, chan, hello):
        self.id = rid
        self.chan = chan
        self.proc = None
        self.hello = hello
        self.hb = None
        self.last_hb = time.monotonic()
        self.draining = False
        self.reader = None

    def depth(self):
        return (self.hb or {}).get("depth", 0)


class _Pending:
    """One in-flight request: the router's own copy of everything
    needed to finish or re-admit it without the replica."""

    __slots__ = ("mid", "kind", "prompt", "max_new", "sampling",
                 "priority", "deadline", "draft", "future", "tokens",
                 "replica_id")

    def __init__(self, mid, kind, future, prompt=None, max_new=None,
                 sampling=None, priority=0, deadline=None, draft=None):
        self.mid = mid
        self.kind = kind               # decode | predict | control
        self.future = future
        self.prompt = prompt
        self.max_new = max_new
        self.sampling = sampling
        self.priority = priority
        self.deadline = deadline       # absolute monotonic, or None
        self.draft = draft
        self.tokens = []               # relayed so far (order of record)
        self.replica_id = None

    def remaining_ms(self, now):
        if self.deadline is None:
            return None
        return max(0.0, (self.deadline - now) * 1e3)


class FleetRouter:
    """Spawn, route, heal, scale (see module docstring).

    `bundle` is the shared serving-bundle directory every replica
    restores. `spawn_fn(rid, port)` overrides process spawning for
    tests (fake in-process replicas dial the port themselves and may
    return None). `policy` is "affinity" (default), "least_loaded",
    or "random" (the benchmark baseline arm). `ctx` is where the
    spawned replicas restore and serve (`--ctx` of
    `python -m mxnet_tpu_torch.fleet.replica`): the current context,
    the card by default.
    """

    def __init__(self, bundle=None, *, replicas=None, port=None,
                 heartbeat_ms=None, policy="affinity", page_size=None,
                 min_replicas=1, max_replicas=8, autoscale=False,
                 autoscaler=None, drain_timeout_ms=None,
                 spawn_fn=None, name="fleet", seed=0, ctx=None):
        from ..context import as_context, current_context

        self.bundle = os.path.abspath(bundle) if bundle else None
        self.ctx = current_context() if ctx is None else as_context(ctx)
        self.n_replicas = (replicas if replicas is not None
                           else _cfg.replicas())
        self.port = port if port is not None else _cfg.port()
        self.hb_s = (heartbeat_ms if heartbeat_ms is not None
                     else _cfg.heartbeat_ms()) / 1e3
        self.drain_timeout_ms = (
            drain_timeout_ms if drain_timeout_ms is not None
            else _cfg.drain_timeout_ms())
        if policy not in ("affinity", "least_loaded", "random"):
            raise ServingError(f"unknown routing policy {policy!r}")
        self.policy = policy
        self.name = name
        kv_dtype = None
        if page_size is None and self.bundle:
            with open(os.path.join(self.bundle, MANIFEST)) as f:
                manifest = json.load(f)
            page_size = manifest.get("page_size")
            kv_dtype = manifest.get("kv_dtype")
        self.affinity = AffinityIndex(page_size or 1,
                                      kv_dtype or "float32")
        self.ledger = DrainLedger()
        self.stats = FleetStats(name, replicas_fn=self._replica_rows)
        if autoscaler is not None:
            self.autoscaler = autoscaler
        elif autoscale:
            self.autoscaler = Autoscaler(min_replicas=min_replicas,
                                         max_replicas=max_replicas)
        else:
            self.autoscaler = None
        self._spawn_fn = spawn_fn
        self._rng = random.Random(seed)   # routing only, never crypto
        self._lock = threading.Lock()
        self._handles = {}             # rid -> ReplicaHandle
        self._pending = {}             # mid -> _Pending
        self._parked = []              # re-admissions awaiting a home
        self._procs = {}               # rid -> Popen (pre-hello too)
        self._mid = 0
        self._next_replica = 0
        self._closed = threading.Event()
        self._listener = None
        self._accept_thread = None
        self._monitor_thread = None

    # ------------------------------------------------------- lifecycle
    def start(self, wait=True, timeout=120):
        """Bind the control-plane listener, spawn the initial replica
        set, and (by default) block until every replica said hello."""
        self._listener = socket.create_server(
            ("127.0.0.1", self.port))
        self._listener.settimeout(_ACCEPT_TIMEOUT_S)
        self.port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"fleet-accept-{self.name}",
            daemon=True)
        self._accept_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop,
            name=f"fleet-monitor-{self.name}", daemon=True)
        self._monitor_thread.start()
        _register(self.name, self.stats)
        for _ in range(self.n_replicas):
            self._spawn_replica()
        if wait:
            self.wait_ready(self.n_replicas, timeout=timeout)
        return self

    def wait_ready(self, n, timeout=120):
        """Timed poll until `n` replicas are connected and live."""
        deadline = time.monotonic() + timeout
        live = 0
        while time.monotonic() < deadline:
            with self._lock:
                live = len(self._handles)
            if live >= n:
                return self
            time.sleep(0.02)
        raise ServingError(
            f"fleet not ready: {live}/{n} replicas after {timeout}s")

    def stop(self, timeout=10):
        """Tear the fleet down: stop every replica, fail anything
        still in flight with ServerClosedError, reap processes."""
        self._closed.set()
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
            pending = list(self._pending.values())
            self._pending.clear()
            pending.extend(p for p, _ in self._parked)
            self._parked = []
            procs = list(self._procs.values())
            self._procs.clear()
        for h in handles:
            h.chan.send({"op": "stop"})
            h.chan.close()
        for p in pending:
            if not p.future.done():
                p.future._fail(ServerClosedError("fleet stopped"))
        for proc in procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=timeout)
            except Exception:
                proc.kill()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=timeout)
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=timeout)
        _unregister(self.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------- spawning
    def _spawn_replica(self):
        with self._lock:
            rid = f"r{self._next_replica}"
            self._next_replica += 1
        if self._spawn_fn is not None:
            proc = self._spawn_fn(rid, self.port)
        else:
            cmd = replica_command(self.bundle, self.port, rid,
                                  self.hb_s * 1e3, self.ctx)
            proc = subprocess.Popen(cmd)
        if proc is not None:
            with self._lock:
                self._procs[rid] = proc
        return rid

    def scale(self, n):
        """Grow (spawn) or shrink (drain least-loaded) to n replicas.
        Returns the replica ids spawned or draining."""
        n = int(n)
        if n < 1:
            raise ServingError("a fleet needs at least one replica")
        with self._lock:
            live = [h for h in self._handles.values()
                    if not h.draining]
        delta = n - len(live)
        out = []
        if delta > 0:
            for _ in range(delta):
                out.append(self._spawn_replica())
        else:
            victims = sorted(live, key=lambda h: self._load(h))
            for h in victims[:-delta]:
                if self.drain_replica(h.id, wait=False):
                    out.append(h.id)
        return out

    # -------------------------------------------------------- routing
    def _load(self, handle):
        """Effective load: the worse of the heartbeat's queue depth
        (authoritative but stale) and the router's own in-flight
        count (fresh but blind to local submitters)."""
        with self._lock:
            inflight = sum(1 for p in self._pending.values()
                           if p.replica_id == handle.id
                           and p.kind == "decode")
        return max(handle.depth(), inflight)

    def _candidates(self):
        with self._lock:
            return [h for h in self._handles.values()
                    if not h.draining]

    def _pick_replica(self, prompt=None):
        """(handle, policy_used, pages_covered) for one request."""
        cands = self._candidates()
        if not cands:
            raise ServerClosedError("no live replicas")
        if self.policy == "random":
            return self._rng.choice(cands), "random", 0
        if self.policy == "affinity" and prompt is not None:
            by_id = {h.id: h for h in cands}
            rid, cover = self.affinity.best(prompt, list(by_id))
            if rid is not None:
                return by_id[rid], "affinity", cover
        return (min(cands, key=lambda h: (self._load(h), h.id)),
                "least_loaded", 0)

    def _new_pending(self, kind, future_cb=None, **kw):
        with self._lock:
            self._mid += 1
            mid = f"m{self._mid}"
        fut = FleetFuture(mid, cancel_cb=future_cb or self._on_cancel)
        pend = _Pending(mid, kind, fut, **kw)
        with self._lock:
            self._pending[mid] = pend
        return pend

    def _on_cancel(self, fut):
        with self._lock:
            pend = self._pending.get(fut.mid)
            handle = (self._handles.get(pend.replica_id)
                      if pend is not None else None)
        if handle is not None:
            handle.chan.send({"op": "cancel", "id": fut.mid})

    def submit(self, prompt, max_new_tokens=None, priority=0,
               deadline_ms=None, sampling=None, seed=None,
               draft=None):
        """Route one decode request; returns a FleetFuture (same
        surface as DecodeFuture: result/stream/cancel)."""
        if self._closed.is_set():
            raise ServerClosedError("fleet stopped")
        prompt = [int(t) for t in prompt]
        if sampling is not None and not isinstance(sampling, dict):
            # a decoding.SamplingParams (or lookalike): the wire
            # carries plain JSON
            sampling = {"temperature": sampling.temperature,
                        "top_k": sampling.top_k,
                        "top_p": sampling.top_p,
                        "seed": sampling.seed}
        if seed is not None:
            sampling = dict(sampling or {}, seed=int(seed))
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        pend = self._new_pending(
            "decode", prompt=prompt, max_new=max_new_tokens,
            sampling=sampling, priority=int(priority),
            deadline=deadline, draft=draft)
        try:
            handle, policy, cover = self._pick_replica(prompt)
        except Exception:
            with self._lock:
                self._pending.pop(pend.mid, None)
            raise
        pend.replica_id = handle.id
        self.stats.note_routed(policy, cover)
        msg = {"op": "generate", "id": pend.mid, "prompt": prompt,
               "max_new_tokens": max_new_tokens,
               "priority": int(priority), "sampling": sampling,
               "draft": draft}
        rem = pend.remaining_ms(time.monotonic())
        if rem is not None:
            msg["deadline_ms"] = rem
        handle.chan.send(msg)
        return pend.future

    def generate(self, prompt, timeout=None, **kw):
        return self.submit(prompt, **kw).result(timeout)

    def stream(self, prompt, timeout=None, **kw):
        return self.submit(prompt, **kw).stream(timeout=timeout)

    def predict(self, inputs, deadline_ms=None, timeout=None):
        """One-shot inference on the least-loaded replica (inputs:
        {name: nested-list/array}; returns the output arrays as
        nested lists — the control plane never ships tensors)."""
        if self._closed.is_set():
            raise ServerClosedError("fleet stopped")
        import numpy as np

        pend = self._new_pending("predict")
        handle, policy, _ = self._pick_replica(None)
        pend.replica_id = handle.id
        self.stats.note_routed(policy)
        handle.chan.send(
            {"op": "predict", "id": pend.mid,
             "inputs": {k: np.asarray(v).tolist()
                        for k, v in inputs.items()},
             "deadline_ms": deadline_ms})
        return pend.future.result(timeout)

    def replica_stats(self, rid, timeout=10):
        """Fresh stats snapshot straight from one replica."""
        with self._lock:
            handle = self._handles.get(rid)
        if handle is None:
            raise ServingError(f"no replica {rid}")
        pend = self._new_pending("control")
        pend.replica_id = rid
        handle.chan.send({"op": "stats", "id": pend.mid})
        return pend.future.result(timeout)

    # ---------------------------------------------------------- drain
    def drain_replica(self, rid, timeout_ms=None, wait=True,
                      timeout=60):
        """Order one replica to drain (stop admitting, finish or
        hand off live decodes, exit). Returns the drain future's
        handoff count when wait=True, else True once ordered; False
        if the replica is unknown or already draining."""
        if timeout_ms is None:
            timeout_ms = self.drain_timeout_ms
        with self._lock:
            handle = self._handles.get(rid)
        if handle is None:
            return False
        # escalation slack past the replica's own deadline: handler
        # flush + a few heartbeats of exit latency
        if not self.ledger.begin(rid, time.monotonic(),
                                 timeout_ms / 1e3
                                 + 5 * self.hb_s + 1.0):
            return False
        handle.draining = True
        pend = self._new_pending("control")
        pend.replica_id = rid
        handle.chan.send({"op": "drain", "id": pend.mid,
                          "timeout_ms": timeout_ms})
        if not wait:
            return True
        result = pend.future.result(timeout)
        return result.get("handoffs", 0) if isinstance(result, dict) \
            else 0

    # ------------------------------------------------------ re-admission
    def _rebuild_state(self, pend, now):
        """Resume record from the router's OWN copy (replica died
        without handing off)."""
        st = {"prompt": list(pend.prompt),
              "generated": list(pend.tokens),
              "max_new_tokens": pend.max_new,
              "priority": pend.priority,
              "sampling": pend.sampling,
              "draft": bool(pend.draft)}
        rem = pend.remaining_ms(now)
        if rem is not None:
            st["deadline_ms"] = rem
        return st

    def _reassign(self, pend, state):
        """Re-admit one in-flight decode elsewhere (drain handoff or
        death rebuild). Parks it when no replica is available —
        the monitor retries as soon as one is."""
        try:
            state = check_handoff_state(state)
        except ServingError as exc:
            self.stats.note_failure()
            if not pend.future.done():
                pend.future._fail(exc)
            return
        # the router's token record is authoritative; a handoff from
        # a healthy drain matches it exactly, a partial one cannot
        # shrink it (tokens already relayed to the caller stand)
        if len(state["generated"]) < len(pend.tokens):
            state["generated"] = list(pend.tokens)
        else:
            pend.tokens = list(state["generated"])
        if pend.max_new is not None \
                and len(pend.tokens) >= pend.max_new:
            if not pend.future.done():
                pend.future._finish(list(pend.tokens), "max_tokens")
            with self._lock:
                self._pending.pop(pend.mid, None)
            return
        cands = self._candidates()
        if not cands:
            with self._lock:
                self._parked.append((pend, state))
            return
        by_id = {h.id: h for h in cands}
        rid, cover = self.affinity.best(state["prompt"], list(by_id))
        handle = by_id[rid] if rid is not None else min(
            cands, key=lambda h: (self._load(h), h.id))
        pend.replica_id = handle.id
        with self._lock:
            self._pending[pend.mid] = pend
        self.stats.note_readmission()
        handle.chan.send({"op": "resume", "id": pend.mid,
                          "state": state})

    # ------------------------------------------------- reader plumbing
    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._greet, args=(sock,),
                             daemon=True).start()

    def _greet(self, sock):
        """First frame decides the connection's role: a replica hello
        registers a handle and becomes its reader loop; an admin
        hello (the CLI) serves control queries inline."""
        chan = Channel(sock, name="greet")
        hello = chan.recv()
        if not isinstance(hello, dict) or hello.get("op") != "hello":
            chan.close()
            return
        if hello.get("role") == "admin":
            self._admin_loop(chan)
            return
        rid = hello["id"]
        handle = ReplicaHandle(rid, chan, hello)
        chan.name = rid
        if hello.get("page_size") and self.affinity.page_size <= 1:
            # router built without a bundle manifest: adopt the page
            # size the replicas actually decode with
            self.affinity.page_size = int(hello["page_size"])
        if hello.get("kv_dtype"):
            # adopt the replicas' KV storage precision so prompt
            # chains are seeded to match their advertisements (a
            # replica at a DIFFERENT dtype keeps its own seed and
            # simply never wins affinity — cross-dtype page matches
            # are impossible by construction)
            self.affinity.kv_dtype = str(hello["kv_dtype"])
        with self._lock:
            handle.proc = self._procs.get(rid)
            self._handles[rid] = handle
        handle.reader = threading.current_thread()
        self._reader_loop(handle)

    def _reader_loop(self, handle):
        while True:
            msg = handle.chan.recv()
            if msg is None:
                self._on_disconnect(handle)
                return
            try:
                self._on_message(handle, msg)
            except Exception:
                # a poisoned frame must not kill the reader; the
                # request-level error paths report specifics
                self.stats.note_failure()

    def _on_message(self, handle, msg):
        if msg.get("op") == "hb":
            handle.hb = msg
            handle.last_hb = time.monotonic()
            if "prefixes" in msg:
                self.affinity.update(handle.id, msg["prefixes"])
            return
        mid = msg.get("id")
        with self._lock:
            pend = self._pending.get(mid)
        if pend is None:
            return                      # late frame of a settled request
        if "tok" in msg:
            pend.tokens.append(int(msg["tok"]))
            pend.future._emit(msg["tok"])
            return
        if "done" in msg:
            done = msg["done"] or {}
            with self._lock:
                self._pending.pop(mid, None)
            if pend.kind == "decode":
                pend.future._finish(list(pend.tokens),
                                    done.get("reason"))
            else:
                pend.future._finish(done)
            return
        if "handoff" in msg:
            self.ledger.note_handoff(handle.id)
            self.stats.note_handoff()
            with self._lock:
                self._pending.pop(mid, None)
            self._reassign(pend, msg["handoff"])
            return
        if "outputs" in msg:
            with self._lock:
                self._pending.pop(mid, None)
            pend.future._finish(msg["outputs"])
            return
        if "stats" in msg:
            with self._lock:
                self._pending.pop(mid, None)
            pend.future._finish(msg["stats"])
            return
        if "error" in msg:
            err = msg["error"]
            etype, emsg = err.get("type"), err.get("msg", "")
            if etype in ("ServerClosedError", "ServerBusyError") \
                    and pend.kind == "decode":
                # replica refused admission (draining/full): this is
                # a placement problem, not the request's — re-route
                with self._lock:
                    self._pending.pop(mid, None)
                self._reassign(pend,
                               self._rebuild_state(
                                   pend, time.monotonic()))
                return
            with self._lock:
                self._pending.pop(mid, None)
            self.stats.note_failure()
            exc = {"DeadlineExceededError": DeadlineExceededError,
                   "ServerBusyError": ServerBusyError,
                   "ServerClosedError": ServerClosedError,
                   }.get(etype, ServingError)(emsg)
            pend.future._fail(exc)

    # ------------------------------------------------------ retirement
    def _retire(self, rid):
        """Claim exclusive ownership of a replica's retirement: only
        the caller that pops the handle proceeds (settles the
        monitor-vs-reader race)."""
        with self._lock:
            return self._handles.pop(rid, None)

    def _orphans(self, rid):
        with self._lock:
            out = [p for p in self._pending.values()
                   if p.replica_id == rid]
            for p in out:
                self._pending.pop(p.mid, None)
        return out

    def _on_disconnect(self, handle):
        if self._closed.is_set():
            return
        h = self._retire(handle.id)
        if h is None:
            return                     # monitor already retired it
        expected = self.ledger.finish(handle.id) is not None
        self._finish_retire(h, expected)

    def _finish_retire(self, handle, expected):
        handle.chan.close()
        self.affinity.remove(handle.id)
        with self._lock:
            proc = self._procs.pop(handle.id, None)
        if proc is not None:
            if proc.poll() is None:
                # still running after retirement (stale heartbeats /
                # escalated drain): it no longer serves — kill it
                try:
                    proc.kill()
                except Exception:
                    pass
            try:
                proc.wait(timeout=10)
            except Exception:
                pass
        if not expected:
            self.stats.note_replica_death()
            if not self._closed.is_set():
                # heal: an UNEXPECTED death gets a one-for-one
                # replacement (drains are deliberate shrinks and
                # don't) — orphans parked below re-admit once the
                # replacement says hello
                self._spawn_replica()
        now = time.monotonic()
        for pend in self._orphans(handle.id):
            if pend.future.done():
                continue
            if pend.kind == "decode":
                # zero-loss: rebuild from the router's token record
                self._reassign(pend, self._rebuild_state(pend, now))
            else:
                pend.future._fail(ServingError(
                    f"replica {handle.id} died mid-request"))

    # --------------------------------------------------------- monitor
    def _monitor_tick(self, now):
        with self._lock:
            handles = list(self._handles.values())
            parked = self._parked
            self._parked = []
        # 1) parked re-admissions (a replica may have appeared)
        for pend, state in parked:
            self._reassign(pend, state)
        # 2) heartbeat staleness -> retire + rebuild
        for h in handles:
            dead = now - h.last_hb > _STALE_HEARTBEATS * self.hb_s
            if h.proc is not None and h.proc.poll() is not None:
                dead = True            # process exited without EOF yet
            if dead and self._retire(h.id) is not None:
                expected = self.ledger.finish(h.id) is not None
                self._finish_retire(h, expected)
        # 3) drain deadline escalation: kill, then the rebuild path
        for rid in self.ledger.expired(now):
            h = self._retire(rid)
            if h is None:
                continue
            self.ledger.finish(rid, escalated=True)
            if h.proc is not None:
                try:
                    h.proc.kill()
                except Exception:
                    pass
            self._finish_retire(h, True)
        # 4) router-level deadline sweep (a dead replica can't expire
        #    its own queue)
        with self._lock:
            expired = [p for p in self._pending.values()
                       if p.deadline is not None and now > p.deadline]
            for p in expired:
                self._pending.pop(p.mid, None)
        for p in expired:
            self.stats.note_failure()
            if not p.future.done():
                p.future._fail(DeadlineExceededError(
                    f"deadline passed after {len(p.tokens)} tokens"))
            with self._lock:
                h = self._handles.get(p.replica_id)
            if h is not None:
                h.chan.send({"op": "cancel", "id": p.mid})
        # 5) autoscale on the heartbeat view
        live = [h for h in self._candidates()]
        if live:
            mean_depth = sum(self._load(h) for h in live) / len(live)
            self.stats.note_fleet_gauges(len(live), mean_depth)
            if self.autoscaler is not None:
                delta = self.autoscaler.observe(mean_depth, len(live))
                if delta > 0:
                    self.stats.note_autoscale(delta)
                    self._spawn_replica()
                elif delta < 0:
                    victim = min(live, key=lambda h: self._load(h))
                    self.stats.note_autoscale(delta)
                    self.drain_replica(victim.id, wait=False)

    def _monitor_loop(self):
        while not self._closed.wait(self.hb_s):
            try:
                self._monitor_tick(time.monotonic())
            except Exception:
                self.stats.note_failure()

    # ----------------------------------------------------------- admin
    def _replica_rows(self):
        with self._lock:
            handles = list(self._handles.values())
        rows = {}
        for h in handles:
            hb = h.hb or {}
            st = hb.get("stats", {})
            rows[h.id] = {
                "depth": hb.get("depth", 0),
                "draining": h.draining,
                "pid": h.hello.get("pid"),
                "model": h.hello.get("model"),
                "traces": h.hello.get("traces"),
                "compiles": h.hello.get("compiles"),
                "prefix_hit_rate": st.get("prefix_hit_rate"),
                "kv_occupancy": st.get("kv_occupancy"),
                "pages_allocated": st.get("pages_allocated"),
                "advertised_prefixes": len(
                    self.affinity.advertised(h.id)),
            }
        return rows

    def status(self):
        with self._lock:
            n_pending = len(self._pending)
            n_parked = len(self._parked)
        out = {"name": self.name, "port": self.port,
               "policy": self.policy, "bundle": self.bundle,
               "pending": n_pending, "parked": n_parked,
               "replicas": self._replica_rows()}
        out.update(self.ledger.snapshot())
        return out

    def _admin_loop(self, chan):
        """Inline service of one CLI connection (status/scale/drain).
        Runs on the greeter thread; every request gets a reply frame
        {"id", "result"} or {"id", "error"}."""
        while not self._closed.is_set():
            msg = chan.recv()
            if msg is None:
                chan.close()
                return
            mid = msg.get("id")
            try:
                op = msg.get("op")
                if op == "status":
                    result = self.status()
                elif op == "scale":
                    result = {"changed": self.scale(msg["n"])}
                elif op == "drain":
                    result = {"handoffs": self.drain_replica(
                        msg["replica"],
                        timeout_ms=msg.get("timeout_ms"))}
                elif op == "stop":
                    chan.send({"id": mid, "result": {"stopped": True}})
                    chan.flush(timeout=5)
                    self.stop()
                    chan.close()
                    return
                else:
                    raise ServingError(f"unknown admin op {op!r}")
                chan.send({"id": mid, "result": result})
            except Exception as exc:
                chan.send({"id": mid,
                           "error": {"type": type(exc).__name__,
                                     "msg": str(exc)}})
