"""Length-prefixed JSON framing for the fleet control plane
(mxnet_tpu/fleet/wire.py): the same frames, byte for byte.

One frame = 4-byte big-endian payload length + UTF-8 JSON. Small,
debuggable (`nc` + `xxd` reads it), and stdlib-only — the control
plane moves token ids and stat snapshots, never tensors, so JSON's
overhead is noise next to a decode step.

`Channel` wraps a connected socket with the fleet's concurrency
discipline:

  * all WRITES go through one writer thread draining an UNBOUNDED
    outbox queue — `send()` is a lock-free, non-blocking enqueue, so
    no caller ever blocks on a peer's receive window (and no socket
    `sendall` can ever run under a lock);
  * all READS belong to exactly one reader thread per channel, which
    calls `recv()` in its own loop — again never under a lock.

Frames from different sender threads interleave at frame granularity
(the writer thread serializes them); there is no cross-frame ordering
contract beyond per-sender FIFO, which is all the router/replica
protocol needs.
"""
from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time

# control frames are stat snapshots and token batches; 64 MiB is far
# above any legitimate frame and bounds a corrupted length prefix
MAX_FRAME = 64 << 20

_LEN = struct.Struct(">I")


class WireError(Exception):
    """Framing violation (oversized/garbled frame)."""


def send_frame(sock, obj):
    """Serialize + write one frame (blocking; callers that must not
    block use a Channel instead)."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME:
        raise WireError(f"frame of {len(payload)} bytes exceeds "
                        f"MAX_FRAME={MAX_FRAME}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    """Read exactly n bytes, or None on clean EOF."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock):
    """Read one frame; None on clean EOF (peer closed)."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise WireError(f"incoming frame of {n} bytes exceeds "
                        f"MAX_FRAME={MAX_FRAME}")
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    return json.loads(payload.decode("utf-8"))


class Channel:
    """One connected control-plane socket (see module docstring for
    the threading discipline). `send` never blocks; `recv` blocks the
    (single) reader thread; `close` is idempotent and unblocks both
    sides."""

    def __init__(self, sock, name=""):
        self.sock = sock
        self.name = name
        self._outbox = queue.Queue()   # unbounded: put never blocks
        self._closed = threading.Event()
        self._writer = threading.Thread(
            target=self._write_loop,
            name=f"fleet-wire-{name}", daemon=True)
        self._writer.start()

    def _write_loop(self):
        while True:
            obj = self._outbox.get()
            if obj is None:
                return
            try:
                send_frame(self.sock, obj)
            except OSError:
                return          # peer gone; reader surfaces the EOF

    def send(self, obj):
        """Enqueue one frame for the writer thread (non-blocking);
        silently dropped if the channel is closed — the peer's death
        is reported through the reader side, not here."""
        if not self._closed.is_set():
            self._outbox.put(obj)

    def recv(self):
        """Read one frame (reader thread only); None on EOF/close."""
        try:
            return recv_frame(self.sock)
        except (OSError, ValueError):
            return None

    def flush(self, timeout=5.0):
        """Best-effort timed wait for the outbox to reach the wire
        (a replica about to exit calls this so its last frames are
        not lost to the process teardown)."""
        deadline = time.monotonic() + timeout
        while not self._outbox.empty():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def close(self):
        if self._closed.is_set():
            return
        self._closed.set()
        self._outbox.put(None)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    @property
    def closed(self):
        return self._closed.is_set()
