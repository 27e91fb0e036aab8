"""Length-prefixed framed RPC over local sockets — the serving plane's
wire; the port's own copy of ``repro.serving.rpc`` (numpy only).

Frame layout (little-endian)::

    u32 frame_len | u32 header_len | header JSON | buffer 0 | buffer 1 ...

The header is an ordinary JSON object; any top-level numpy-array value
of the message is lifted out of the JSON and shipped as a raw buffer,
described in the header's ``__arrays__`` list as ``[key, dtype, shape]``
in buffer order.  Decoding reverses the lift, so both ends see one flat
``dict`` with real ``np.ndarray`` values — no base64, no pickling.  The
frames are the reference's: a router of either package talks to a
worker of the other.

* :class:`RpcServer` — thread-per-connection server with a **bounded
  inflight gate**: at most ``max_inflight`` requests may be queued or
  executing; request number ``max_inflight + 1`` is answered immediately
  with ``{"status": "overloaded"}`` instead of queueing unboundedly
  (the worker half of the plane's admission control — the router half
  lives in ``repro_torch.serving.router``).
* :class:`RpcClient` — thread-safe client with a small connection pool;
  concurrent calls each hold a pooled connection exclusively, so a
  hedged backup request never interleaves frames with the primary.

Tablet worker processes import this without torch
(``repro_torch.serving.tablet_server``).
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Callable, Optional

import numpy as np

_LEN = struct.Struct("<I")
# one frame must hold a whole coalesced batch of patterns (or a full
# locate enumeration); 256 MiB is orders of magnitude above either while
# still rejecting a corrupt length prefix before it allocates the moon
MAX_FRAME = 256 << 20


class RpcError(RuntimeError):
    """Transport-level failure: connect/send/recv on a dead endpoint."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def encode_message(msg: dict) -> bytes:
    """One frame.  Top-level ndarray values ride as raw buffers."""
    header: dict = {}
    arrays: list = []
    buffers: list[bytes] = []
    for key, value in msg.items():
        if isinstance(value, np.ndarray):
            arr = np.ascontiguousarray(value)
            arrays.append([key, arr.dtype.str, list(arr.shape)])
            buffers.append(arr.tobytes())
        else:
            header[key] = value
    header["__arrays__"] = arrays
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body = b"".join([_LEN.pack(len(hdr)), hdr] + buffers)
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame of {len(body)} bytes exceeds MAX_FRAME")
    return _LEN.pack(len(body)) + body


def decode_message(body: bytes) -> dict:
    """Inverse of :func:`encode_message`."""
    (hdr_len,) = _LEN.unpack_from(body, 0)
    off = _LEN.size
    header = json.loads(body[off:off + hdr_len].decode("utf-8"))
    off += hdr_len
    msg = {k: v for k, v in header.items() if k != "__arrays__"}
    for key, dtype, shape in header.get("__arrays__", []):
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * dt.itemsize
        arr = np.frombuffer(body[off:off + nbytes], dtype=dt)
        msg[key] = arr.reshape(shape).copy()
        off += nbytes
    return msg


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise RpcError("connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_message(sock: socket.socket, msg: dict) -> None:
    try:
        sock.sendall(encode_message(msg))
    except OSError as e:
        raise RpcError(f"send failed: {e}") from e


def recv_message(sock: socket.socket) -> dict:
    try:
        (frame_len,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
        if frame_len > MAX_FRAME:
            raise RpcError(f"frame length {frame_len} exceeds MAX_FRAME")
        return decode_message(_recv_exact(sock, frame_len))
    except OSError as e:
        raise RpcError(f"recv failed: {e}") from e


def overloaded_response(queue_depth: int) -> dict:
    """The typed shed result (docs/serving_plane.md, admission control)."""
    return {"status": "overloaded", "queue_depth": int(queue_depth)}


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class RpcServer:
    """Unix-socket server: one thread per connection, bounded inflight.

    ``handler(msg) -> dict`` runs every admitted request; a request
    arriving while ``max_inflight`` others are queued or executing is
    shed with :func:`overloaded_response` WITHOUT running the handler —
    the bounded per-worker queue the plane's backpressure contract
    promises.  ``stats_hook`` (optional) observes ``(op, service_ms,
    shed)`` per request for the worker's metrics feed.
    """

    def __init__(self, path: str, handler: Callable[[dict], dict], *,
                 max_inflight: int = 8,
                 stats_hook: Optional[Callable] = None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {max_inflight}")
        self.path = path
        self.handler = handler
        self.max_inflight = int(max_inflight)
        self.stats_hook = stats_hook
        self._inflight = 0
        self._shed = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        if os.path.exists(path):
            os.unlink(path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(path)
        self._listener.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True)
        self._accept_thread.start()

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def shed_count(self) -> int:
        with self._lock:
            return self._shed

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return                       # listener closed by stop()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="rpc-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        import time
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_message(conn)
                except RpcError:
                    return                   # client went away
                with self._lock:
                    if self._inflight >= self.max_inflight:
                        self._shed += 1
                        depth = self._inflight
                        admitted = False
                    else:
                        self._inflight += 1
                        admitted = True
                if not admitted:
                    if self.stats_hook is not None:
                        self.stats_hook(msg.get("op", "?"), 0.0, True)
                    send_message(conn, overloaded_response(depth))
                    continue
                t0 = time.perf_counter()
                try:
                    try:
                        reply = self.handler(msg)
                    except Exception as e:  # noqa: BLE001 — reply, don't die
                        reply = {"status": "error",
                                 "error": f"{type(e).__name__}: {e}"}
                finally:
                    with self._lock:
                        self._inflight -= 1
                if self.stats_hook is not None:
                    self.stats_hook(msg.get("op", "?"),
                                    (time.perf_counter() - t0) * 1e3, False)
                send_message(conn, reply)
        finally:
            conn.close()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class RpcClient:
    """Thread-safe client for one endpoint, with connection pooling.

    Each :meth:`call` holds one pooled connection exclusively for its
    whole request/response exchange, so concurrent callers (the router's
    fan-out threads, a hedged backup) never interleave frames.  A failed
    exchange closes its connection; the next call dials fresh.
    """

    def __init__(self, path: str, *, timeout: float = 30.0,
                 pool_size: int = 8):
        self.path = path
        self.timeout = float(timeout)
        self.pool_size = int(pool_size)
        self._pool: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False

    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise RpcError(f"client for {self.path} is closed")
            if self._pool:
                return self._pool.pop()
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        try:
            sock.connect(self.path)
        except OSError as e:
            sock.close()
            raise RpcError(f"connect to {self.path} failed: {e}") from e
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._pool) < self.pool_size:
                self._pool.append(sock)
                return
        sock.close()

    def call(self, msg: dict, *, timeout: Optional[float] = None) -> dict:
        """One request/response exchange; raises :class:`RpcError` on
        any transport failure (the router treats that as a dead replica
        and fails over)."""
        sock = self._checkout()
        try:
            if timeout is not None:
                sock.settimeout(timeout)
            send_message(sock, msg)
            reply = recv_message(sock)
        except (RpcError, OSError) as e:
            sock.close()
            if isinstance(e, RpcError):
                raise
            raise RpcError(f"call to {self.path} failed: {e}") from e
        if timeout is not None:
            sock.settimeout(self.timeout)
        self._checkin(sock)
        return reply

    def ping(self, *, timeout: float = 1.0) -> bool:
        try:
            return self.call({"op": "ping"},
                             timeout=timeout).get("status") == "ok"
        except RpcError:
            return False

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, []
        for sock in pool:
            sock.close()
