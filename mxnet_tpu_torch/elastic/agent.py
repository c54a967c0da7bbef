"""The elastic worker agent: one training process under coordinator
control (mxnet_tpu/elastic/agent.py: the same protocol and flags, plus
`--ctx`).

A worker's whole life is a loop of lock-step global steps (grads →
combined rows → slice updates → full params), interrupted at ANY wait
point by a `quiesce` frame — the worker acks its last completed step,
discards whatever half-step it staged (pending slice updates are
copies; nothing commits until the `params` broadcast lands), and waits
for `resume` to re-key rank/world/sampler before continuing. The
aborted step re-runs under the new ownership, so a membership change
costs at most one repeated gradient computation and never a skipped or
double-applied one.

Durability is asymmetric on purpose: the worker persists nothing but
its consumed-example log (the exactly-once evidence the CI gate
audits) — params and momentum live in the coordinator mirror, so a
SIGKILLed worker (FaultInjector 'kill:step:N') takes no unique state
with it.

`run_worker` adds the auto-rejoin loop: a lost coordinator connection
(restart, network blip) re-dials with fresh hellos inside the
MXNET_ELASTIC_REJOIN_MS budget; a successful re-dial joins as a new
member and is bootstrapped through the normal re-grow transition.

Runnable as `python -m mxnet_tpu_torch.elastic.agent --connect
HOST:PORT --entry pkg.mod:fn [--config JSON] [--ctx gpu|gpu:N|cpu]`.
The worker computes its gradients on its context: the card (`gpu`, the
default) unless `cpu` is named; with no card and no `--ctx cpu` it exits
non-zero before it says hello. On the card it pins cuDNN, cuBLAS and
TF32 to deterministic settings in its own process before it binds
(`trainer.deterministic_card`), so its gradients have the bits any other
worker's would.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time

from ..base import MXNetError
from ..fleet.wire import Channel
from . import codec, config as cfg
from .trainer import ElasticSGD, load_entry, ModuleStepper


class _Lost(Exception):
    """Coordinator connection gone (EOF / refused)."""


class _Stop(Exception):
    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


class _Rekeyed(Exception):
    """Membership changed mid-step; restart the step loop."""


def _traces():
    """The exec cache's `traces`: bind plans this process constructed."""
    from .. import exec_cache

    return int(exec_cache.cache_stats().get("traces", 0))


class ElasticWorker(object):
    """One worker process of an elastic job. The module/stepper is
    built once, on `ctx` (the current context when None: the card
    unless the CPU is named), and survives rejoins — params always come
    from the coordinator, so reconnecting re-installs state without ever
    building the bind plan again."""

    def __init__(self, connect, entry, config=None, *, name=None,
                 heartbeat_ms=None, fault_injector=None,
                 consumed_log=None, ctx=None):
        host, _, port = str(connect).rpartition(":")
        if not host or not port.isdigit():
            raise MXNetError(
                f"bad elastic endpoint {connect!r}: expected "
                "'host:port'")
        self._addr = (host, int(port))
        self._entry = str(entry)
        self._config = dict(config or {})
        self._name = name or f"worker-{os.getpid()}"
        self._hb_s = (heartbeat_ms if heartbeat_ms is not None
                      else cfg.heartbeat_ms()) / 1000.0
        if fault_injector is None:
            from ..fault import FaultInjector

            fault_injector = FaultInjector()
        self._injector = fault_injector
        self._log_path = consumed_log
        self._log_f = None

        self._spec = load_entry(self._entry)(self._config)
        self._stepper = ModuleStepper(self._spec, ctx=ctx)
        self._sampler = self._spec.make_sampler()
        self._sgd = ElasticSGD(self._spec.lr, self._spec.momentum)
        self._params = self._stepper.params()
        self._mom = self._sgd.init_state(
            {n: v.shape for n, v in self._params.items()})

        # membership view (set by welcome/resume frames)
        self.wid = None
        self.rank = -1
        self.world = 0
        self.gen = 0
        self._step = 0                # completed global steps
        self._bounds = {}

        self._hb_lock = threading.Lock()
        self._hb_digest = None
        self._chan = None
        self._inbox = None
        self._session_over = threading.Event()

    # --------------------------------------------------------- running
    def run(self, rejoin_ms=None):
        """Join the job, auto-rejoining on a lost coordinator within
        the MXNET_ELASTIC_REJOIN_MS budget. Returns (reason, final
        params) — reason 'complete' when the job finished."""
        budget_s = (rejoin_ms if rejoin_ms is not None
                    else cfg.rejoin_ms()) / 1000.0
        deadline = None
        while True:
            try:
                return self._session()
            except _Lost as e:
                now = time.monotonic()
                if deadline is None:
                    deadline = now + budget_s
                if now >= deadline:
                    raise MXNetError(
                        f"elastic worker {self._name}: coordinator at "
                        f"{self._addr[0]}:{self._addr[1]} unreachable "
                        f"past the rejoin budget ({e})")
                time.sleep(min(self._hb_s, max(0.01,
                                               deadline - now)))

    def close(self):
        """Drop the coordinator connection (tests use this to
        simulate a silent death without SIGKILLing the process)."""
        self._session_over.set()
        if self._chan is not None:
            self._chan.close()

    def params(self):
        return {n: v.copy() for n, v in self._params.items()}

    @property
    def stepper(self):
        return self._stepper

    @property
    def completed_steps(self):
        return self._step

    # --------------------------------------------------------- session
    def _session(self):
        try:
            sock = socket.create_connection(self._addr, timeout=5.0)
        except OSError as e:
            raise _Lost(f"connect: {e}")
        chan = Channel(sock, name=f"elastic-{self._name}")
        inbox = queue.Queue()
        self._chan, self._inbox = chan, inbox
        self._session_over.clear()

        def _read_loop():
            while True:
                msg = chan.recv()
                inbox.put(msg)
                if msg is None:
                    return

        threading.Thread(target=_read_loop, daemon=True,
                         name=f"elastic-{self._name}-reader").start()
        # hello MUST be enqueued before the heartbeat thread starts:
        # the coordinator rejects a channel whose first frame is not
        # hello, and the outbox only guarantees per-sender FIFO
        chan.send({"op": "hello", "pid": os.getpid(),
                   "name": self._name, "traces": _traces()})
        threading.Thread(target=self._hb_loop, args=(chan,),
                         daemon=True,
                         name=f"elastic-{self._name}-hb").start()
        try:
            boot = self._await(("welcome",))
            self._apply(boot)
            return self._step_loop()
        except _Stop as stop:
            return stop.reason, self.params()
        finally:
            self._session_over.set()
            chan.close()

    def _hb_loop(self, chan):
        while not self._session_over.is_set():
            # the step and the digest of the parameters after it, read
            # as one pair (both change together under the lock)
            with self._hb_lock:
                digest, step = self._hb_digest, self._step - 1
            chan.send({"op": "heartbeat", "step": step,
                       "traces": _traces(), "digest": digest})
            self._session_over.wait(self._hb_s)

    # -------------------------------------------------------- protocol
    def _await(self, ops):
        """Next frame whose op is in `ops`. quiesce/stop/EOF are
        handled from ANY wait point: stop and EOF raise, quiesce runs
        the ack → re-key exchange and raises _Rekeyed so the step
        loop restarts under the new membership."""
        while True:
            msg = self._inbox.get()
            if msg is None:
                raise _Lost("coordinator EOF")
            op = msg.get("op")
            if op == "stop":
                raise _Stop(msg.get("reason", "stop"))
            if op == "quiesce":
                self._chan.send({"op": "quiesced",
                                 "gen": int(msg.get("gen", -1)),
                                 "step": self._step - 1})
                resumed = self._await(("resume", "welcome"))
                self._apply(resumed)
                raise _Rekeyed()
            if op in ops:
                return msg

    def _apply(self, msg):
        """Install one welcome/resume frame: membership, placement
        bounds, moved momentum rows, (for welcome) full params, and
        the sampler re-key."""
        self.wid = msg.get("wid", self.wid)
        self.rank = int(msg["rank"])
        self.world = int(msg["world"])
        self.gen = int(msg["gen"])
        self._bounds = {n: (int(lo), int(hi))
                        for n, (lo, hi) in msg["bounds"].items()}
        with self._hb_lock:
            self._step = int(msg["step"])
            if "params" in msg:
                # the mirror after `step` completed steps
                self._params = codec.decode_tree(msg["params"])
                self._hb_digest = codec.digest(self._params)
        for name, rows in msg.get("opt", {}).items():
            for lo, hi, enc in rows:
                self._mom[name][int(lo):int(hi)] = codec.decode(enc)
        self._stepper.install(self._params)
        epoch, consumed = int(msg["epoch"]), int(msg["consumed"])
        self._sampler.set_epoch(epoch)
        self._sampler.set_membership(self.rank, self.world,
                                     consumed=consumed)

    def _step_loop(self):
        spec = self._spec
        bpe = spec.batches_per_epoch
        while True:
            try:
                if self._step >= spec.total_steps:
                    self._await(())   # drain until stop arrives
                else:
                    self._one_step(spec, bpe)
            except _Rekeyed:
                continue

    def _one_step(self, spec, bpe):
        epoch, p = divmod(self._step, bpe)
        if self._sampler.epoch != epoch:
            self._sampler.set_epoch(epoch)
            self._sampler.set_membership(self.rank, self.world)
        owned = self._sampler.owned_shards
        batches = {s: self._sampler.shard_batch(s, p) for s in owned}
        shard_grads = {
            s: self._stepper.grads(*spec.batch_arrays(batches[s]))
            for s in owned}
        self._chan.send({
            "op": "grads", "gen": self.gen, "step": self._step,
            "shards": {str(s): codec.encode_tree(g)
                       for s, g in shard_grads.items()}})

        combined = self._await(("combined",))
        pending_p, pending_m = {}, {}
        for name, (lo, hi, enc) in combined.get("rows", {}).items():
            lo, hi = int(lo), int(hi)
            g_rows = codec.decode(enc)
            p_rows = self._params[name][lo:hi].copy()
            m_rows = self._mom[name][lo:hi].copy()
            self._sgd.update(p_rows, g_rows, m_rows)
            pending_p[name] = (lo, hi, p_rows)
            pending_m[name] = (lo, hi, m_rows)
        self._chan.send({
            "op": "slices", "gen": self.gen, "step": self._step,
            "params": {n: [lo, hi, codec.encode(v)]
                       for n, (lo, hi, v) in pending_p.items()},
            "opt": {n: [lo, hi, codec.encode(v)]
                    for n, (lo, hi, v) in pending_m.items()}})

        done = self._await(("params",))
        # COMMIT point: only now does local state advance
        self._params = codec.decode_tree(done["params"])
        for name, (lo, hi, v) in pending_m.items():
            self._mom[name][lo:hi] = v
        self._stepper.install(self._params)
        digest = codec.digest(self._params)
        self._log_consumed(epoch, p, owned, batches)
        self._injector.note_step()
        # the completed step and its digest change together: a heartbeat
        # between the two would pair the old step with the new digest,
        # a mismatch against every other member at that step
        with self._hb_lock:
            self._hb_digest = digest
            self._step += 1

    def _log_consumed(self, epoch, p, owned, batches):
        """One JSONL line per owned shard of the completed step — the
        exactly-once audit trail (append + flush before note_step can
        kill us, so the log never claims an unapplied batch and never
        omits an applied one)."""
        if self._log_path is None:
            return
        if self._log_f is None:
            self._log_f = open(self._log_path, "a")
        for s in owned:
            self._log_f.write(json.dumps({
                "epoch": epoch, "step": p, "gstep": self._step,
                "shard": int(s), "rank": self.rank,
                "idx": [int(i) for i in batches[s]]}) + "\n")
        self._log_f.flush()


def run_worker(connect, entry, config=None, **kwargs):
    """Join an elastic job as a worker (blocking); returns (reason,
    final params). Keyword args pass through to ElasticWorker plus
    `rejoin_ms`."""
    rejoin_ms = kwargs.pop("rejoin_ms", None)
    return ElasticWorker(connect, entry, config=config,
                         **kwargs).run(rejoin_ms=rejoin_ms)


def parse_ctx(text):
    """The worker's Context from `--ctx`: `cpu`, `gpu` or `gpu:N`."""
    from ..context import cpu, gpu

    kind, _, index = text.partition(":")
    if kind == "cpu" and not index:
        return cpu()
    if kind == "gpu":
        return gpu(int(index or 0))
    raise ValueError(f"--ctx {text!r}: expected cpu, gpu or gpu:N")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.elastic.agent",
        description="elastic training worker agent")
    ap.add_argument("--connect", required=True,
                    help="coordinator endpoint host:port")
    ap.add_argument("--entry", required=True,
                    help="job factory 'pkg.mod:fn'")
    ap.add_argument("--config", default="{}",
                    help="JSON config for the job factory")
    ap.add_argument("--name", default=None)
    ap.add_argument("--consumed-log", default=None,
                    help="JSONL exactly-once audit log path")
    ap.add_argument("--rejoin-ms", type=int, default=None)
    ap.add_argument("--ready-file", default=None,
                    help="touch this path once the worker is built "
                         "(interpreter warm, step program bound) — "
                         "lets a harness sequence joins without "
                         "guessing startup time")
    ap.add_argument("--ctx", type=parse_ctx, default="gpu",
                    help="where the worker computes its gradients: gpu "
                         "(the card, default), gpu:N or cpu")
    ap.add_argument("--start-gate", default=None,
                    help="hold the dial until this path exists — the "
                         "release side of --ready-file (the elastic "
                         "CI gate warms a joiner first, then releases "
                         "it mid-run at a chosen step)")
    args = ap.parse_args(argv)
    # no card and no `--ctx cpu`: MXNetError here, before the hello
    args.ctx.torch_device()
    worker = ElasticWorker(
        args.connect, args.entry, config=json.loads(args.config),
        name=args.name, consumed_log=args.consumed_log, ctx=args.ctx)
    if args.ready_file:
        with open(args.ready_file, "w") as f:
            f.write(str(os.getpid()))
    if args.start_gate:
        while not os.path.exists(args.start_gate):
            time.sleep(0.02)
    reason, _params = worker.run(rejoin_ms=args.rejoin_ms)
    print(json.dumps({"result": reason}))
    return 0 if reason in ("complete", "shutdown") else 1


if __name__ == "__main__":
    raise SystemExit(main())
