"""Framed socket transport: one ``Channel`` per TCP connection (the port
of ``repro.rt.transport``).

Whole frames are written under a lock, so a device's heartbeat thread
can interleave with its main loop without corrupting the stream (TCP
preserves order; receivers always see complete frames). Receives are
single-consumer by construction: the server runs one reader thread per
connection, devices receive only from their main loop.

Timeout semantics: ``recv(timeout)`` bounds the wait for the *start* of
a frame (``RpcTimeout``); once a header has arrived the body is given a
generous fixed budget, because sends are atomic whole frames — a stall
mid-frame means the peer died mid-write (``TruncatedFrame``), not that
it is merely slow. EOF between frames is ``ConnectionClosed``.

Fault hooks: an attached ``FaultInjector`` is consulted on every send —
'delay' sleeps first, 'drop' swallows the frame (the caller believes it
sent, exercising retry), 'disconnect' hard-closes the socket and raises
``InjectedDisconnect``.
"""
from __future__ import annotations

import os
import signal
import socket
import threading
import time
from typing import Any, Callable, Optional, Tuple

from repro_torch.rt import protocol as pr
from repro_torch.rt.faults import FaultInjector, InjectedDisconnect

_BODY_TIMEOUT = 60.0      # mid-frame stall budget (peer died mid-write)


class RpcTimeout(RuntimeError):
    pass


def _read_exact(sock: socket.socket, n: int, timeout: Optional[float],
                mid_frame: bool) -> bytes:
    """Read exactly n bytes; socket timeouts become RpcTimeout (frame
    start) or TruncatedFrame (mid-frame); EOF likewise."""
    buf = b""
    deadline = None if timeout is None else time.monotonic() + timeout
    while len(buf) < n:
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0:
                if mid_frame or buf:
                    raise pr.TruncatedFrame(
                        f"stalled with {len(buf)} of {n} bytes")
                raise RpcTimeout("no frame within timeout")
            sock.settimeout(left)
        else:
            sock.settimeout(None)
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if mid_frame or buf:
                raise pr.TruncatedFrame(
                    f"stalled with {len(buf)} of {n} bytes") from None
            raise RpcTimeout("no frame within timeout") from None
        if not chunk:
            if mid_frame or buf:
                raise pr.TruncatedFrame(
                    f"EOF with {len(buf)} of {n} bytes")
            raise pr.ConnectionClosed("peer closed the connection")
        buf += chunk
    return buf


class Channel:
    def __init__(self, sock: socket.socket,
                 injector: Optional[FaultInjector] = None,
                 round_fn: Optional[Callable[[], Optional[int]]] = None):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock
        self.injector = injector
        self.round_fn = round_fn or (lambda: None)
        self._send_lock = threading.Lock()
        # senders (main + heartbeat thread) race close(): both the flag
        # and the socket writes serialize on _send_lock
        self._closed = False       # guarded-by: _send_lock

    # -- send ------------------------------------------------------------

    def send(self, mtype: pr.MsgType, payload: Any) -> bool:
        """Send one frame. Returns False when a 'drop' fault swallowed
        it; raises InjectedDisconnect on a 'disconnect' fault."""
        buf = pr.frame(mtype, payload)
        if self.injector is not None:
            act = self.injector.on_send(mtype, self.round_fn())
            if act is not None:
                kind, delay = act
                if kind == "drop":
                    return False
                if kind == "kill":
                    # a real crash, not an exception: no BYE, no socket
                    # shutdown, no atexit — exactly what SIGKILL does
                    os.kill(os.getpid(), signal.SIGKILL)
                if kind == "disconnect":
                    self.close()
                    raise InjectedDisconnect(
                        f"injected disconnect on {mtype.name}")
                if kind == "delay" and delay > 0:
                    time.sleep(delay)
        with self._send_lock:
            if self._closed:
                raise pr.ConnectionClosed("channel already closed")
            self.sock.sendall(buf)
        return True

    # -- recv ------------------------------------------------------------

    def recv(self, timeout: Optional[float] = None
             ) -> Tuple[pr.MsgType, Any]:
        hdr = _read_exact(self.sock, pr.HEADER.size, timeout,
                          mid_frame=False)
        mtype, length = pr.parse_header(hdr)
        body = _read_exact(self.sock, length, _BODY_TIMEOUT,
                           mid_frame=True) if length else b""
        return mtype, pr.decode_payload(body)

    def close(self):
        with self._send_lock:
            if self._closed:
                return
            self._closed = True
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.sock.close()


def connect_with_retry(host: str, port: int, total_timeout: float = 20.0,
                       backoff0: float = 0.1) -> socket.socket:
    """Dial with exponential backoff until the listener is up (workers
    race the orchestrator's bind at spawn time)."""
    deadline = time.monotonic() + total_timeout
    backoff = backoff0
    while True:
        try:
            return socket.create_connection((host, port), timeout=5.0)
        except OSError:
            if time.monotonic() + backoff > deadline:
                raise
            time.sleep(backoff)
            backoff = min(backoff * 2, 2.0)
