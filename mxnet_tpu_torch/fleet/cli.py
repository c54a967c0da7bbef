"""Run and operate a multi-replica serving fleet (the counterpart of
tools/mx_fleet.py).

    # bring up a 3-replica fleet from one shared serving bundle on the
    # card (prints {"port": ...} once every replica said hello, then
    # serves until interrupted); --ctx cpu restores it on the host
    python -m mxnet_tpu_torch.fleet.cli start --bundle clf.bundle \
        --replicas 3

    # operate a running fleet over its admin control plane
    python -m mxnet_tpu_torch.fleet.cli status --connect 127.0.0.1:7311
    python -m mxnet_tpu_torch.fleet.cli scale 5 --connect 127.0.0.1:7311
    python -m mxnet_tpu_torch.fleet.cli drain r0 --connect 127.0.0.1:7311
    python -m mxnet_tpu_torch.fleet.cli stop --connect 127.0.0.1:7311

`start` owns the FleetRouter in-process; every other command is a
thin admin-protocol client (one length-prefixed JSON exchange over
the router's control-plane port, `fleet/wire.py`), so it works
against a fleet started by anyone, the JAX package's included.
"""
from __future__ import annotations

import argparse
import json
import signal
import socket
import sys
import threading


def admin_call(addr, op, **kw):
    """One admin-protocol exchange: hello, request, reply. Raises
    SystemExit with the router's message on an error reply."""
    from .wire import recv_frame, send_frame

    host, _, port = addr.rpartition(":")
    sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                    timeout=60)
    try:
        send_frame(sock, {"op": "hello", "role": "admin"})
        send_frame(sock, dict(kw, op=op, id="cli"))
        reply = recv_frame(sock)
    finally:
        sock.close()
    if reply is None:
        raise SystemExit("fleet router closed the connection")
    if "error" in reply:
        err = reply["error"]
        raise SystemExit(f"{err.get('type')}: {err.get('msg')}")
    return reply.get("result")


def cmd_start(args):
    from . import FleetRouter
    from .replica import parse_ctx

    router = FleetRouter(
        args.bundle, replicas=args.replicas, port=args.port,
        policy=args.policy, autoscale=args.autoscale,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        name=args.name, ctx=parse_ctx(args.ctx))
    router.start(wait=True, timeout=args.timeout)
    print(json.dumps({"port": router.port,
                      "replicas": sorted(router.status()["replicas"]),
                      "policy": router.policy}))
    sys.stdout.flush()
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        # the admin `stop` op also ends the process: wake on either
        while not stop.wait(0.5):
            if router._closed.is_set():
                return 0
    finally:
        router.stop()
    return 0


def cmd_status(args):
    print(json.dumps(admin_call(args.connect, "status"), indent=2,
                     sort_keys=True))
    return 0


def cmd_scale(args):
    print(json.dumps(admin_call(args.connect, "scale", n=args.n)))
    return 0


def cmd_drain(args):
    print(json.dumps(admin_call(args.connect, "drain",
                                replica=args.replica,
                                timeout_ms=args.timeout_ms)))
    return 0


def cmd_stop(args):
    print(json.dumps(admin_call(args.connect, "stop")))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.fleet.cli",
        description="run and operate a multi-replica serving fleet")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="run a fleet router in-process")
    sp.add_argument("--bundle", required=True,
                    help="shared serving-bundle directory "
                         "(serving.save_bundle)")
    sp.add_argument("--replicas", type=int, default=None)
    sp.add_argument("--port", type=int, default=None,
                    help="control-plane port (default "
                         "MXNET_FLEET_PORT; 0 = ephemeral)")
    sp.add_argument("--policy", default="affinity",
                    choices=("affinity", "least_loaded", "random"))
    sp.add_argument("--autoscale", action="store_true")
    sp.add_argument("--min-replicas", type=int, default=1)
    sp.add_argument("--max-replicas", type=int, default=8)
    sp.add_argument("--name", default="fleet")
    sp.add_argument("--timeout", type=float, default=300.0,
                    help="seconds to wait for every replica's hello")
    sp.add_argument("--ctx", default="gpu",
                    help="where the replicas restore and serve: gpu "
                         "(the card, default), gpu:N or cpu")
    sp.set_defaults(fn=cmd_start)

    for name, fn in (("status", cmd_status), ("stop", cmd_stop)):
        sp = sub.add_parser(name)
        sp.add_argument("--connect", required=True,
                        help="router control-plane HOST:PORT")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("scale", help="grow or drain to N replicas")
    sp.add_argument("n", type=int)
    sp.add_argument("--connect", required=True)
    sp.set_defaults(fn=cmd_scale)

    sp = sub.add_parser("drain",
                        help="drain one replica (zero-loss shrink)")
    sp.add_argument("replica", help="replica id (see status)")
    sp.add_argument("--connect", required=True)
    sp.add_argument("--timeout-ms", type=int, default=None)
    sp.set_defaults(fn=cmd_drain)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
