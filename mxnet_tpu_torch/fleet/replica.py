"""Fleet replica worker: one serving process behind the router
(mxnet_tpu/fleet/replica.py).

Spawned by the router (`python -m mxnet_tpu_torch.fleet.replica
--bundle ... --connect HOST:PORT --id rN --ctx gpu`), a replica
restores the SHARED serving bundle through `ModelServer.load_bundle`
on its context (`--ctx`: the card, `gpu`, unless `cpu` is named; with
no card and no `--ctx cpu` it exits non-zero before it restores
anything) — no bind plan built and no nvcc run on an env-compatible
bundle (`restore_cost()`, the hello's `traces` and `compiles`) —
dials back to the router, and then speaks the wire protocol:

  router -> replica   generate / resume / predict / cancel / stats /
                      drain / stop
  replica -> router   hello (pid, model, page size, restore cost),
                      hb (queue depth + stats snapshot + radix-cache
                      digest, full prefix advertisement only when the
                      digest changed), and per-request frames:
                      {"id", "tok"} streams, then exactly one of
                      {"id", "done"} | {"id", "handoff"} |
                      {"id", "error"}

Every decode request runs on its own handler thread iterating the
model's TokenStream, so a slow consumer never stalls the reader, and
a drain resolves naturally: `ModelServer.drain` raises
RequestHandedOff into the live streams, each handler converts its
exception into a handoff frame (the single source of handoff
records — the drain reply only carries the count), and the process
exits once the handlers flush.

The worker holds NO locks of its own: per-field single-writer
discipline (reader thread owns dispatch, each handler owns its
request) plus the Channel's writer-thread outbox.
"""
from __future__ import annotations

import os
import socket
import sys
import threading

from . import config as _cfg
from .wire import Channel

_HANDLER_FLUSH_S = 10


def restore_cost():
    """Trace/compile counters for the hello frame (measured after
    load_bundle: both must be 0 for an env-compatible bundle).

    `traces` is the exec cache's (a bind plan constructed). `compiles`
    is what a restore must skip: a bind plan built rather than restored
    from the disk tier, or an nvcc run. deviceStats also bills each CUDA
    graph a decoder captures at warmup as a compile; a graph cannot be
    serialized, so every restore captures its cells again, and those
    records are left out here."""
    from .. import exec_cache, kernels
    from ..profiling import device_stats

    stats = device_stats()
    captured = sum(r["executables"] - r.get("disk_loads", 0)
                   for r in stats.get("executables", {}).values()
                   if r.get("graphed"))
    compiles = stats.get("totals", {}).get("compiles", 0) - captured
    return {"traces": exec_cache.cache_stats()["traces"],
            "compiles": compiles + kernels.nvcc_runs()}


class ReplicaWorker:
    """Protocol loop of one replica (see module docstring). Owns a
    ModelServer with ONE model (the bundle's) and a Channel to the
    router; `run()` blocks until the router vanishes, a drain
    completes, or a stop arrives."""

    def __init__(self, server, model, channel, replica_id,
                 heartbeat_ms=None, hello_extra=None):
        self.server = server
        self.model = model
        self.chan = channel
        self.id = replica_id
        self.hb_s = (heartbeat_ms if heartbeat_ms is not None
                     else _cfg.heartbeat_ms()) / 1e3
        self.hello_extra = dict(hello_extra or {})
        self._stop = threading.Event()
        self._futures = {}       # request id -> live future
        self._handlers = []      # handler threads (reader-appended)
        self._draining = False   # reader/drain threads, monotonic

    # ---------------------------------------------------------- frames
    def _hello(self):
        is_decoder = hasattr(self.model, "scheduler")
        msg = {"op": "hello", "id": self.id, "pid": os.getpid(),
               "model": self.model.name,
               "version": self.model.version,
               "kind": "decoded" if is_decoder else "served"}
        if is_decoder:
            msg["page_size"] = self.model.engine.page_size
            msg["kv_dtype"] = self.model.engine.kv_dtype
        msg.update(self.hello_extra)
        return msg

    def _heartbeat(self, last_digest):
        msg = {"op": "hb", "id": self.id,
               "draining": self._draining}
        if hasattr(self.model, "scheduler"):
            waiting, active = self.model.scheduler.depth()
            msg["depth"] = waiting + active
            cache = self.model.scheduler.cache
            if cache is not None:
                digest = cache.cache_digest()
                msg["digest"] = digest
                if digest != last_digest:
                    msg["prefixes"] = cache.cached_prefixes()
        else:
            msg["depth"] = self.model.stats._queue_depth_fn() \
                if self.model.stats._queue_depth_fn else 0
        msg["stats"] = self.model.stats.snapshot()
        return msg

    def _heartbeat_loop(self):
        last_digest = None
        while not self._stop.is_set():
            msg = self._heartbeat(last_digest)
            last_digest = msg.get("digest", last_digest)
            self.chan.send(msg)
            self._stop.wait(self.hb_s)

    # -------------------------------------------------------- handlers
    def _send_error(self, mid, exc):
        self.chan.send({"id": mid,
                        "error": {"type": type(exc).__name__,
                                  "msg": str(exc)}})

    def _handle_decode(self, mid, submit):
        """One request's lifetime: stream tokens out, then exactly
        one terminal frame (done | handoff | error)."""
        from ..decoding.scheduler import RequestHandedOff

        try:
            fut = submit()
            self._futures[mid] = fut
            for tok in fut.stream():
                self.chan.send({"id": mid, "tok": tok})
            self.chan.send({"id": mid,
                            "done": {"reason": fut.finish_reason}})
        except RequestHandedOff as exc:
            self.chan.send({"id": mid, "handoff": exc.state})
        except Exception as exc:
            self._send_error(mid, exc)
        finally:
            self._futures.pop(mid, None)

    def _handle_predict(self, mid, msg):
        import numpy as np

        try:
            inputs = {k: np.asarray(v)
                      for k, v in msg["inputs"].items()}
            outs = self.server.predict(
                self.model.name, inputs,
                deadline_ms=msg.get("deadline_ms"))
            self.chan.send({"id": mid,
                            "outputs": [np.asarray(o).tolist()
                                        for o in outs]})
        except Exception as exc:
            self._send_error(mid, exc)

    def _do_drain(self, mid, timeout_ms):
        self._draining = True
        if timeout_ms is None:
            timeout_ms = _cfg.drain_timeout_ms()
        states = self.server.drain(timeout=timeout_ms / 1e3)
        # the live handlers turn their RequestHandedOff into handoff
        # frames — wait for them so every record is on the wire
        # before the drain reply announces the count
        for t in list(self._handlers):
            if t is threading.current_thread():
                continue
            t.join(timeout=_HANDLER_FLUSH_S)
        n = sum(len(v) for v in states.values())
        self.chan.send({"id": mid, "done": {"handoffs": n}})
        self.chan.flush(timeout=_HANDLER_FLUSH_S)
        self._stop.set()
        self.chan.close()       # unblocks the reader: clean exit

    def _spawn(self, target, *args):
        t = threading.Thread(target=target, args=args, daemon=True)
        self._handlers.append(t)
        t.start()

    # ------------------------------------------------------------ loop
    def _dispatch(self, msg):
        op = msg.get("op")
        mid = msg.get("id")
        if op == "generate":
            def submit(m=msg):
                return self.model.submit(
                    m["prompt"],
                    max_new_tokens=m.get("max_new_tokens"),
                    priority=m.get("priority", 0),
                    deadline_ms=m.get("deadline_ms"),
                    sampling=m.get("sampling"),
                    draft=m.get("draft"))
            self._spawn(self._handle_decode, mid, submit)
        elif op == "resume":
            def submit(m=msg):
                return self.model.admit_resumed(m["state"])
            self._spawn(self._handle_decode, mid, submit)
        elif op == "predict":
            self._spawn(self._handle_predict, mid, msg)
        elif op == "cancel":
            fut = self._futures.get(mid)
            if fut is not None:
                fut.cancel()
        elif op == "stats":
            self.chan.send({"id": mid,
                            "stats": self._heartbeat(None)})
        elif op == "drain":
            self._spawn(self._do_drain, mid, msg.get("timeout_ms"))
        elif op == "stop":
            self._stop.set()
            self.chan.close()

    def run(self):
        self.chan.send(self._hello())
        hb = threading.Thread(target=self._heartbeat_loop,
                              name=f"fleet-hb-{self.id}", daemon=True)
        hb.start()
        while not self._stop.is_set():
            msg = self.chan.recv()
            if msg is None:
                # router gone (or drain closed the channel): a replica
                # without a control plane stops serving
                self._stop.set()
                break
            self._dispatch(msg)
        return 0


def parse_ctx(text):
    """The replica's Context from `--ctx`: `cpu`, `gpu` or `gpu:N`."""
    from ..context import cpu, gpu

    kind, _, index = text.partition(":")
    if kind == "cpu" and not index:
        return cpu()
    if kind == "gpu":
        return gpu(int(index or 0))
    raise ValueError(f"--ctx {text!r}: expected cpu, gpu or gpu:N")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.fleet.replica",
        description="fleet replica worker (spawned by FleetRouter)")
    p.add_argument("--bundle", required=True,
                   help="serving bundle directory (save_bundle "
                        "artifact) shared by every replica")
    p.add_argument("--connect", required=True,
                   help="router control-plane address, HOST:PORT")
    p.add_argument("--id", required=True, help="replica id (rN)")
    p.add_argument("--heartbeat-ms", type=int, default=None)
    p.add_argument("--ctx", type=parse_ctx, default="gpu",
                   help="where the bundle is restored and served: gpu "
                        "(the card, default), gpu:N or cpu")
    args = p.parse_args(argv)

    from ..serving import ModelServer

    # no card and no `--ctx cpu`: MXNetError here, before the restore
    args.ctx.torch_device()
    server = ModelServer()
    with args.ctx:
        model = server.load_bundle(args.bundle)
    host, port = args.connect.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)))
    chan = Channel(sock, name=args.id)
    worker = ReplicaWorker(server, model, chan, args.id,
                           heartbeat_ms=args.heartbeat_ms,
                           hello_extra=restore_cost())
    try:
        return worker.run()
    finally:
        chan.close()


if __name__ == "__main__":
    sys.exit(main())
