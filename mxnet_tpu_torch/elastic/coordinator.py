"""The elastic training coordinator: membership + step engine +
three-step transitions (mxnet_tpu/elastic/coordinator.py: the same
protocol, frames, run-log records and transition checkpoints — the
checkpoint is npz + JSON under the JAX package's format tag, which
needs neither orbax nor JAX).

One coordinator process owns the job: the authoritative param/
optimizer mirror, the membership table, and the global step counter.
Workers dial in over the fleet wire (hello → welcome) and then run
lock-step global steps, two round trips each:

  phase A   every worker sends the gradients of the logical shards it
            owns; when all S logical shards are in, the coordinator
            combines them (fixed shard-order mean — trainer.py) and
            returns to each worker ONLY the rows of the combined
            gradient that worker's placement owns;
  phase B   each owner applies the elementwise update to its rows and
            sends back (param, momentum) slices; the coordinator
            commits them into the mirror and broadcasts the full
            updated params — the step is complete, and the mirror is
            the durability point (a worker that dies takes no state
            with it that the coordinator does not already hold).

Any membership change (reader EOF, stale heartbeat, or a new hello)
raises a transition flag; at the next step boundary the monitor
drives three steps:

  1. QUIESCE  broadcast `quiesce`; workers abort their half-done step
     (nothing was committed — phase-B slices stage in a pending
     buffer on both sides) and ack at their last completed step. The
     barrier + step is persisted via the numerics RunEventLog and a
     transition checkpoint (params/opt + per-param spec strings).
  2. RESHARD  old and new `{'fsdp': world}` ShardingPlan placements
     are diffed by stable member id (reshard.py); each survivor
     receives only the momentum rows it newly owns, joiners get a
     full bootstrap — moved bytes vs the restore-everyone baseline
     are counted in elasticStats.
  3. RE-KEY   the resume/welcome frames carry (rank', world',
     consumed); every worker re-keys its Philox ShardedSampler with
     `set_membership`, so the remaining epoch stream covers every
     unconsumed example exactly once.

Concurrency discipline (MX006–MX008): all socket writes are Channel
outbox enqueues, every socket read belongs to one reader thread, the
monitor sleeps only in `Condition.wait`, and the lock order is
coordinator → stats, never reversed (the stats view calls the member
table only after dropping its own lock).
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np

from ..base import MXNetError
from ..fleet.wire import Channel
from ..numerics.runlog import RunEventLog
from . import codec, config as cfg, reshard
from .stats import ElasticStats, _register, _unregister
from .trainer import combine_grads, ElasticSGD, load_entry

CKPT_FORMAT = "mxnet_tpu/elastic_transition_v1"


class _Member(object):
    __slots__ = ("wid", "chan", "state", "rank", "pid", "last_hb",
                 "last_step", "traces", "trace_history", "digest",
                 "bounds", "quiesced_gen")

    def __init__(self, wid, chan):
        self.wid = wid
        self.chan = chan
        self.state = "pending"        # pending | active | dead
        self.rank = -1
        self.pid = None
        self.last_hb = time.monotonic()
        self.last_step = -1
        self.traces = -1
        self.trace_history = []       # [(last_step, traces)] on change
        self.digest = None
        self.bounds = {}              # {param: (lo, hi)} owned rows
        self.quiesced_gen = -1


class ElasticCoordinator(object):
    """Run one elastic training job. `entry` ('pkg.mod:fn') + JSON
    `config` name the job; every worker resolves the same pair, so
    only state — never code — crosses the wire."""

    def __init__(self, entry, config=None, *, name="job", workdir=None,
                 initial_world=1, port=None, heartbeat_ms=None,
                 quiesce_timeout_ms=None, min_world=None):
        self._entry = str(entry)
        self._config = dict(config or {})
        if cfg.logical_shards() > 0:
            self._config.setdefault("logical_shards",
                                    cfg.logical_shards())
        self._spec = load_entry(self._entry)(self._config)
        self._name = str(name)
        self._workdir = workdir
        self._initial_world = int(initial_world)
        self._hb_s = (heartbeat_ms if heartbeat_ms is not None
                      else cfg.heartbeat_ms()) / 1000.0
        self._quiesce_s = (quiesce_timeout_ms
                           if quiesce_timeout_ms is not None
                           else cfg.quiesce_timeout_ms()) / 1000.0
        self._min_world = (min_world if min_world is not None
                           else cfg.min_world())
        S = self._spec.logical_shards
        if not 1 <= self._initial_world <= S:
            raise MXNetError(
                f"initial_world {self._initial_world} out of range "
                f"for {S} logical shards")

        # authoritative training state: seeded initial params (a pure
        # function of the JobSpec — shape template by symbol shape
        # inference, no module bind, no compile), then the mirror of
        # every completed step
        self._shapes = self._spec.param_shapes()
        self._params = self._spec.initial_params(self._shapes)
        self._opt = ElasticSGD(self._spec.lr, self._spec.momentum) \
            .init_state(self._shapes)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._members = {}            # wid -> _Member
        self._next_wid = 0
        self._gen = 0
        self._world = 0               # world of the current generation
        self._step = 0                # completed global steps
        self._phase = "forming"       # forming|grads|slices|boundary|
                                      # quiesce|parked|done
        self._change_wanted = False
        self._grads_buf = {}          # shard -> {param: np}
        self._pending_rows = []       # [(tree, name, lo, hi, arr)]
        self._slices_seen = set()     # wids reported this step
        self._stop = threading.Event()
        self._done = threading.Event()
        self._threads = []

        self._stats = ElasticStats(self._name, self._member_rows)
        _register(self._name, self._stats)
        self._runlog = None
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self._runlog = RunEventLog(
                os.path.join(workdir, "runlog.jsonl"))
            self._runlog.open(context={
                "role": "elastic_coordinator", "job": self._name,
                "entry": self._entry,
                "logical_shards": S,
                "total_steps": self._spec.total_steps})

        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1",
                             port if port is not None else cfg.port()))
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]

    # ------------------------------------------------------- lifecycle
    def start(self):
        for target, tag in ((self._accept_loop, "accept"),
                            (self._monitor_loop, "monitor")):
            t = threading.Thread(
                target=target,
                name=f"elastic-{self._name}-{tag}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def wait(self, timeout=None):
        """Block until the job completes; True when it did."""
        return self._done.wait(timeout)

    def stop(self):
        self._stop.set()
        with self._lock:
            members = list(self._members.values())
            self._cv.notify_all()
        for m in members:
            m.chan.send({"op": "stop", "reason": "shutdown"})
        for m in members:
            m.chan.flush(1.0)
            m.chan.close()
        try:
            self._listener.close()
        except OSError:
            pass
        _unregister(self._name)
        if self._runlog is not None:
            self._runlog.close()

    def final_params(self):
        """The mirror after the last completed step ({name: np},
        copies)."""
        with self._lock:
            return {n: v.copy() for n, v in self._params.items()}

    def status(self):
        with self._lock:
            return {
                "port": self.port,
                "job": self._name,
                "phase": self._phase,
                "generation": self._gen,
                "step": self._step,
                "total_steps": self._spec.total_steps,
                "world": sum(1 for m in self._members.values()
                             if m.state == "active"),
                "members": self._member_rows_locked(),
            }

    # --------------------------------------------------------- members
    def _member_rows_locked(self):
        rows = []
        for wid in sorted(self._members):
            m = self._members[wid]
            rows.append({
                "wid": m.wid, "state": m.state, "rank": m.rank,
                "pid": m.pid, "last_step": m.last_step,
                "traces": m.traces,
                "trace_history": list(m.trace_history),
                "stale_s": round(time.monotonic() - m.last_hb, 3),
            })
        return rows

    def _member_rows(self):
        with self._lock:
            return self._member_rows_locked()

    def _actives(self):
        return sorted((m for m in self._members.values()
                       if m.state == "active"),
                      key=lambda m: m.wid)

    def _pendings(self):
        return sorted((m for m in self._members.values()
                       if m.state == "pending"),
                      key=lambda m: m.wid)

    # ----------------------------------------------------- I/O threads
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.settimeout(None)
            t = threading.Thread(
                target=self._reader_loop, args=(sock,),
                name=f"elastic-{self._name}-reader", daemon=True)
            t.start()

    def _reader_loop(self, sock):
        chan = Channel(sock, name="elastic")
        msg = chan.recv()
        if not isinstance(msg, dict) or msg.get("op") != "hello":
            chan.close()
            return
        member = self._on_hello(chan, msg)
        while not self._stop.is_set():
            msg = chan.recv()
            if msg is None:
                break
            self._dispatch(member, msg)
        self._on_eof(member)

    def _dispatch(self, m, msg):
        op = msg.get("op")
        if op == "heartbeat":
            self._on_heartbeat(m, msg)
        elif op == "grads":
            self._on_grads(m, msg)
        elif op == "slices":
            self._on_slices(m, msg)
        elif op == "quiesced":
            self._on_quiesced(m, msg)

    # ---------------------------------------------------- frame events
    def _on_hello(self, chan, msg):
        with self._lock:
            wid = f"w{self._next_wid:03d}"
            self._next_wid += 1
            m = _Member(wid, chan)
            m.pid = msg.get("pid")
            m.traces = int(msg.get("traces", -1))
            self._members[wid] = m
            if self._phase == "forming":
                pend = self._pendings()
                if len(pend) >= self._initial_world:
                    self._form_locked(pend[:self._initial_world])
            else:
                self._set_change_locked(True)
                self._cv.notify_all()
        return m

    def _on_heartbeat(self, m, msg):
        with self._lock:
            m.last_hb = time.monotonic()
            m.last_step = int(msg.get("step", m.last_step))
            traces = int(msg.get("traces", m.traces))
            if traces != m.traces:
                m.traces = traces
                m.trace_history.append((m.last_step, traces))
            digest = msg.get("digest")
            if digest:
                m.digest = (m.last_step, digest)
                for other in self._actives():
                    if (other is not m and other.digest
                            and other.digest[0] == m.last_step
                            and other.digest[1] != digest):
                        self._stats.note_digest_mismatch()

    def _on_eof(self, m):
        with self._lock:
            if m.state == "dead":
                return
            was_active = m.state == "active"
            m.state = "dead"
            m.chan.close()
            if was_active:
                self._set_change_locked(True)
                if self._phase in ("grads", "slices"):
                    # the in-flight step cannot complete; nothing was
                    # committed, so dropping the buffers aborts it
                    self._abort_step_locked()
                self._cv.notify_all()

    def _set_phase_locked(self, phase):
        """The ONE writer of the phase field (lock held at every call
        site): the state machine's transitions all pass through here,
        so the write side of the lock protocol has a single audit
        point."""
        self._phase = phase

    def _set_change_locked(self, wanted):
        """Single writer of the change-wanted flag (lock held)."""
        self._change_wanted = bool(wanted)

    def _abort_step_locked(self):
        self._grads_buf.clear()
        del self._pending_rows[:]
        self._slices_seen.clear()
        self._set_phase_locked("boundary")

    def _on_grads(self, m, msg):
        with self._lock:
            if (self._phase != "grads"
                    or int(msg.get("gen", -1)) != self._gen
                    or int(msg.get("step", -1)) != self._step
                    or m.state != "active"):
                return
            shards = msg.get("shards", {})
            for s in sorted(shards):
                self._grads_buf[int(s)] = codec.decode_tree(shards[s])
            S = self._spec.logical_shards
            if len(self._grads_buf) < S:
                return
            combined = combine_grads(self._grads_buf, S)
            self._grads_buf.clear()
            for w in self._actives():
                rows = {}
                for name in sorted(w.bounds):
                    lo, hi = w.bounds[name]
                    rows[name] = [lo, hi,
                                  codec.encode(combined[name][lo:hi])]
                w.chan.send({"op": "combined", "gen": self._gen,
                             "step": self._step, "rows": rows})
            self._set_phase_locked("slices")

    def _on_slices(self, m, msg):
        with self._lock:
            if (self._phase != "slices"
                    or int(msg.get("gen", -1)) != self._gen
                    or int(msg.get("step", -1)) != self._step
                    or m.state != "active"
                    or m.wid in self._slices_seen):
                return
            for tree_name, tree in (("params", msg.get("params", {})),
                                    ("opt", msg.get("opt", {}))):
                for name in sorted(tree):
                    lo, hi, enc = tree[name]
                    self._pending_rows.append(
                        (tree_name, name, int(lo), int(hi),
                         codec.decode(enc)))
            self._slices_seen.add(m.wid)
            if len(self._slices_seen) < len(self._actives()):
                return
            # all owners reported: commit, broadcast, advance
            for tree_name, name, lo, hi, arr in self._pending_rows:
                dst = self._params if tree_name == "params" else \
                    self._opt
                dst[name][lo:hi] = arr
            del self._pending_rows[:]
            self._slices_seen.clear()
            payload = codec.encode_tree(self._params)
            for w in self._actives():
                w.chan.send({"op": "params", "gen": self._gen,
                             "step": self._step, "params": payload})
            self._step += 1
            self._stats.note_step()
            bpe = self._spec.batches_per_epoch
            if self._runlog is not None and self._step % bpe == 0:
                self._runlog.epoch(self._step // bpe - 1)
            if self._step >= self._spec.total_steps:
                self._finish_locked()
            elif self._change_wanted:
                self._set_phase_locked("boundary")
                self._cv.notify_all()
            else:
                self._set_phase_locked("grads")

    def _on_quiesced(self, m, msg):
        with self._lock:
            m.quiesced_gen = int(msg.get("gen", -1))
            self._cv.notify_all()

    # ------------------------------------------------------ monitoring
    def _monitor_loop(self):
        while not self._stop.is_set():
            with self._lock:
                self._cv.wait(timeout=self._hb_s / 2)
                if self._stop.is_set():
                    return
                stale = [m for m in self._actives()
                         if time.monotonic() - m.last_hb
                         > 5 * self._hb_s]
            for m in stale:
                self._on_eof(m)
            with self._lock:
                if (self._phase == "boundary"
                        and self._change_wanted):
                    self._transition_locked()
                elif (self._phase == "parked"
                        and self._pendings()):
                    self._transition_locked()
                elif (self._phase == "grads"
                        and self._change_wanted
                        and not self._grads_buf):
                    # change arrived between steps (no grads in
                    # flight yet): transition right away rather than
                    # waiting out a step that may never complete
                    self._set_phase_locked("boundary")
                    self._transition_locked()

    # ----------------------------------------------------- transitions
    def _form_locked(self, members):
        """Generation 1: bootstrap the initial membership (not counted
        as a transition — there is no old placement to diff)."""
        self._gen = 1
        new_assign = self._place_locked(members)
        for m in members:
            m.state = "active"
        self._send_bootstrap_locked(members, set(m.wid for m in members),
                                    new_assign, {})
        self._world = len(members)
        self._stats.note_membership(len(members), self._gen)
        if self._runlog is not None:
            self._runlog.append({
                "event": "membership", "phase": "form",
                "gen": self._gen, "world": len(members),
                "step": self._step})
        self._set_phase_locked("grads")
        self._set_change_locked(self._pendings())

    def _place_locked(self, members):
        """Assign ranks + owned row bounds to `members` (wid order)
        under a {'fsdp': len(members)} plan; returns the by-wid
        assignment table."""
        world = len(members)
        bounds, _specs = reshard.placement(self._shapes, world)
        wids = []
        for rank, m in enumerate(members):
            m.rank = rank
            wids.append(m.wid)
        assign = reshard.assignment(bounds, wids)
        for m in members:
            m.bounds = {name: row[m.wid]
                        for name, row in assign.items()
                        if m.wid in row}
        return assign

    def _send_bootstrap_locked(self, members, joiner_wids, new_assign,
                               moves):
        """Resume/welcome frames for one new generation; returns moved
        payload bytes."""
        world = len(members)
        epoch = self._step // self._spec.batches_per_epoch
        consumed = self._step % self._spec.batches_per_epoch
        full_params = codec.encode_tree(self._params)
        moved = 0
        for m in members:
            opt_rows = {}
            for name, lo, hi in moves.get(m.wid, []):
                opt_rows.setdefault(name, []).append(
                    [lo, hi, codec.encode(self._opt[name][lo:hi])])
            frame = {
                "op": "welcome" if m.wid in joiner_wids else "resume",
                "wid": m.wid, "gen": self._gen, "rank": m.rank,
                "world": world, "step": self._step, "epoch": epoch,
                "consumed": consumed,
                "total_steps": self._spec.total_steps,
                "bounds": {n: list(b) for n, b in m.bounds.items()},
                "opt": opt_rows,
            }
            for rows in opt_rows.values():
                for _, _, enc in rows:
                    moved += codec.payload_bytes(enc)
            if m.wid in joiner_wids:
                frame["params"] = full_params
                moved += codec.payload_bytes(full_params)
            m.chan.send(frame)
        return moved

    def _transition_locked(self):
        """Quiesce → reshard → re-key (called with the lock held; the
        quiesce barrier waits on the condition variable, so readers
        keep draining acks)."""
        t0 = time.monotonic()
        new_gen = self._gen + 1
        actives = self._actives()
        # the outgoing generation's world, NOT len(actives): the death
        # that triggered us already left the active set, and direction
        # (shrink vs grow) is judged against the world that was
        old_world = self._world
        old_assign = {}
        for m in actives:
            for name, b in m.bounds.items():
                old_assign.setdefault(name, {})[m.wid] = b
        for m in actives:
            m.chan.send({"op": "quiesce", "gen": new_gen,
                         "step": self._step})
        deadline = time.monotonic() + self._quiesce_s
        while True:
            waiting = [m for m in self._actives()
                       if m.quiesced_gen < new_gen]
            if not waiting:
                break
            left = deadline - time.monotonic()
            if left <= 0:
                # stragglers missed the barrier: they are dead to this
                # job now (a worker that cannot ack a quiesce cannot
                # be trusted to stop stepping either)
                for m in waiting:
                    m.state = "dead"
                    m.chan.close()
                break
            self._cv.wait(timeout=left)
            if self._stop.is_set():
                return
        quiesce_wall_ms = (time.monotonic() - t0) * 1000.0
        self._grads_buf.clear()
        del self._pending_rows[:]
        self._slices_seen.clear()

        epoch = self._step // self._spec.batches_per_epoch
        consumed = self._step % self._spec.batches_per_epoch
        if self._runlog is not None:
            self._runlog.append({
                "event": "transition", "phase": "quiesce",
                "gen": new_gen, "step": self._step, "epoch": epoch,
                "consumed": consumed, "world": old_world})
        self._persist_locked(new_gen, old_world)

        survivors = self._actives()
        pend = self._pendings()
        S = self._spec.logical_shards
        room = max(0, S - len(survivors))
        joining, overflow = pend[:room], pend[room:]
        members = sorted(survivors + joining, key=lambda m: m.wid)
        new_world = len(members)
        if new_world < max(1, self._min_world):
            # parked: membership too small to continue. State is
            # durable (runlog + transition checkpoint); a joiner's
            # hello re-triggers this transition.
            self._set_phase_locked("parked")
            self._gen = new_gen
            self._stats.note_membership(new_world, new_gen)
            if self._runlog is not None:
                self._runlog.append({
                    "event": "transition", "phase": "parked",
                    "gen": new_gen, "world": new_world,
                    "min_world": self._min_world})
            return

        self._gen = new_gen
        self._world = new_world
        new_assign = self._place_locked(members)
        for m in joining:
            m.state = "active"
        moves = reshard.member_moves(old_assign, new_assign)
        joiner_wids = set(m.wid for m in joining)
        moved = self._send_bootstrap_locked(
            members, joiner_wids, new_assign, moves)
        baseline = reshard.state_bytes(
            self._shapes, copies=2 * new_world)
        rekeyed = ((self._spec.batches_per_epoch - consumed)
                   * self._spec.batch_size * S)
        direction = "shrink" if new_world < old_world else "grow"
        self._stats.note_transition(
            direction, quiesce_wall_ms, moved, baseline, rekeyed)
        self._stats.note_membership(new_world, new_gen)
        if self._runlog is not None:
            self._runlog.append({
                "event": "transition", "phase": "resume",
                "gen": new_gen, "step": self._step, "epoch": epoch,
                "consumed": consumed, "world": new_world,
                "direction": direction,
                "bytes_moved": moved,
                "bytes_full_restore": baseline,
                "examples_rekeyed": rekeyed,
                "quiesce_wall_ms": round(quiesce_wall_ms, 3)})
        self._set_phase_locked("grads")
        self._set_change_locked(overflow)

    def _persist_locked(self, gen, world):
        """Transition checkpoint: params + opt + meta (step position
        and the per-param spec strings of the OLD layout — what
        reshard diffed against), kill-surviving next to the runlog."""
        if not self._workdir:
            return
        d = os.path.join(self._workdir, f"transition-g{gen:03d}")
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "params.npz"), **self._params)
        np.savez(os.path.join(d, "opt.npz"), **self._opt)
        specs = reshard.fitted_spec_strings(self._shapes, max(1, world))
        meta = {
            "format": CKPT_FORMAT, "gen": gen, "step": self._step,
            "epoch": self._step // self._spec.batches_per_epoch,
            "consumed": self._step % self._spec.batches_per_epoch,
            "world": world, "sharding": specs,
            "entry": self._entry,
            "logical_shards": self._spec.logical_shards,
        }
        tmp = os.path.join(d, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(d, "meta.json"))

    def _finish_locked(self):
        self._set_phase_locked("done")
        if self._runlog is not None:
            self._runlog.append({
                "event": "complete", "step": self._step,
                "gen": self._gen})
        self._persist_locked(self._gen, len(self._actives()))
        for m in self._actives():
            m.chan.send({"op": "stop", "reason": "complete"})
        self._done.set()
        self._cv.notify_all()
