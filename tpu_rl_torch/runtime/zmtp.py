"""ZMTP 3.0 over stdlib sockets: the wire ``tpu_rl``'s pyzmq sockets speak,
without pyzmq.

``tpu_rl.runtime.transport`` builds every TCP channel on libzmq's PUB, SUB,
ROUTER and DEALER sockets. The port speaks the same wire, so its processes
and ``tpu_rl``'s interoperate in both directions, on a machine that has no
pyzmq. It speaks the subset the runtime uses:

- the 64-byte greeting (signature, version 3.0, mechanism ``NULL``,
  as-server 0, zero filler), then one ``READY`` command each way carrying
  ``Socket-Type`` and, for DEALER and ROUTER, ``Identity``;
- message frames flagged MORE/LONG (multipart messages), command frames
  flagged COMMAND;
- a SUB subscribes with the 3.0 message ``\\x01`` + prefix (the port's
  SUB subscribes to everything); a PUB sends a message only to peers whose
  subscriptions match its first part;
- a ROUTER prefixes each received message with the peer's identity (its
  ``Identity`` property, else 5 generated bytes) and routes a reply by it,
  dropping it silently when the peer is gone (``ROUTER_MANDATORY`` unset).

And the behaviours the runtime relies on:

- ``connect`` before the peer binds retries in the background every
  100 ms, and so does a reconnect after the peer restarts;
- a PUB sheds the newest message for a subscriber whose queue is at the
  high-water mark (``hwm`` messages), as libzmq does, and counts it; a
  DEALER or ROUTER sheds at its queue's mark too, instead of blocking;
- no send blocks the caller: a send encodes the message and queues it;
  one I/O thread per socket does the network work (``selectors``);
- ``close()`` gives queued messages up to ``LINGER_S`` (1 s) to reach
  connected peers, then drops the rest and joins the thread.

No CURVE or PLAIN, no other socket type, no option the reference does not
set.
"""

from __future__ import annotations

import errno
import random
import selectors
import socket
import threading
import time
from collections import deque

PUB, SUB, ROUTER, DEALER = "PUB", "SUB", "ROUTER", "DEALER"
# Socket types each may talk to (ZMTP 3.0 / RFC 23's compatibility table).
_PEER_TYPES = {
    PUB: {b"SUB", b"XSUB"},
    SUB: {b"PUB", b"XPUB"},
    ROUTER: {b"DEALER", b"REQ", b"ROUTER"},
    DEALER: {b"ROUTER", b"REP", b"DEALER"},
}

# signature (0xFF, 8 bytes of padding, 0x7F), version 3.0, mechanism NULL
# padded to 20 bytes, as-server 0, 31 bytes of filler
GREETING = (
    b"\xff" + b"\x00" * 7 + b"\x01" + b"\x7f"
    + bytes([3, 0])
    + b"NULL".ljust(20, b"\x00")
    + b"\x00"
    + b"\x00" * 31
)
assert len(GREETING) == 64

_MORE, _LONG, _COMMAND = 0x01, 0x02, 0x04
RECONNECT_S = 0.1  # libzmq's default reconnect interval
LINGER_S = 1.0  # how long close() lets queued messages reach connected peers
_RECV_CHUNK = 1 << 18
_WBUF_FILL = 1 << 18  # bytes moved from the queue into the write buffer at a time


class ZmtpError(ValueError):
    """A peer broke the protocol; its connection is dropped."""


def frame(body: bytes, flags: int = 0) -> bytes:
    n = len(body)
    if n > 255:
        return bytes([flags | _LONG]) + n.to_bytes(8, "big") + body
    return bytes([flags, n]) + body


def encode_message(parts: list[bytes]) -> bytes:
    """One multipart message as ZMTP frames."""
    last = len(parts) - 1
    return b"".join(frame(bytes(p), _MORE if i < last else 0) for i, p in enumerate(parts))


def command(name: bytes, body: bytes = b"") -> bytes:
    return frame(bytes([len(name)]) + name + body, _COMMAND)


def _prop(name: bytes, value: bytes) -> bytes:
    return bytes([len(name)]) + name + len(value).to_bytes(4, "big") + value


def ready_command(kind: str, identity: bytes | None = None) -> bytes:
    body = _prop(b"Socket-Type", kind.encode())
    if kind in (DEALER, ROUTER):
        body += _prop(b"Identity", identity or b"")
    return command(b"READY", body)


def parse_properties(body: bytes) -> dict[str, bytes]:
    """The metadata of a READY command, names lower-cased."""
    props, i = {}, 0
    while i < len(body):
        n = body[i]
        name = body[i + 1:i + 1 + n]
        i += 1 + n
        if i + 4 > len(body):
            raise ZmtpError("truncated READY property")
        m = int.from_bytes(body[i:i + 4], "big")
        i += 4
        if i + m > len(body):
            raise ZmtpError("truncated READY property value")
        props[name.decode("ascii", "replace").lower()] = body[i:i + m]
        i += m
    return props


def check_greeting(g: bytes) -> None:
    if g[0] != 0xFF or not g[9] & 0x01:
        raise ZmtpError("not a ZMTP 3 peer")
    if g[10] < 3:
        raise ZmtpError(f"ZMTP version {g[10]}.{g[11]} is older than 3.0")
    if g[12:32].rstrip(b"\x00") != b"NULL":
        raise ZmtpError(f"mechanism {g[12:32].rstrip(bytes(1))!r} is not NULL")


class _Pipe:
    """One peer: a TCP connection, or a connect endpoint that outlives its
    connections (it reconnects, and a DEALER's queue survives)."""

    __slots__ = (
        "addr", "sock", "state", "rbuf", "wbuf", "woff", "out", "parts",
        "routing_id", "subs", "next_try",
    )

    def __init__(self, addr: tuple[str, int] | None = None):
        self.addr = addr  # set for a connect endpoint
        self.sock: socket.socket | None = None
        self.state = "idle"  # idle | connecting | greeting | handshake | ready
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.woff = 0
        self.out: deque = deque()  # encoded messages queued for this peer
        self.parts: list[bytes] = []  # the multipart message being received
        self.routing_id: bytes | None = None
        self.subs: set[bytes] = set()  # a PUB's view of the peer's subscriptions
        self.next_try = 0.0

    def reset(self) -> None:
        self.sock = None
        self.state = "idle"
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.woff = 0
        self.parts = []
        self.routing_id = None
        self.subs = set()


class ZSocket:
    """One ZMTP socket of ``kind`` (PUB, SUB, ROUTER or DEALER) with its own
    I/O thread. ``hwm`` bounds each peer's send queue and the receive queue,
    in messages."""

    def __init__(self, kind: str, hwm: int = 1000, identity: bytes | None = None):
        if kind not in _PEER_TYPES:
            raise ValueError(f"unsupported socket type {kind!r}")
        self.kind = kind
        self.hwm = max(1, int(hwm))
        self.identity = identity
        self.n_dropped = 0  # messages shed at a full queue
        self.n_unroutable = 0  # ROUTER replies to an identity not connected
        self.n_protocol_errors = 0
        self._lock = threading.Condition()
        self._pipes: list[_Pipe] = []
        self._routes: dict[bytes, _Pipe] = {}
        self._listeners: list[socket.socket] = []
        self._inbox: deque = deque()
        self._rr = 0
        self._next_id = random.getrandbits(32)
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._woken = False
        self._closing = False
        self._closed = False
        self._interest: dict[int, int] = {}
        self.on_message = None  # called (on the I/O thread) when a message lands
        self._thread = threading.Thread(target=self._run, name=f"zmtp-{kind}", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- control
    def bind(self, ip: str, port: int) -> None:
        host = "0.0.0.0" if ip in ("*", "") else ip
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            ls.bind((host, int(port)))
            ls.listen(128)
        except OSError:
            ls.close()
            raise
        ls.setblocking(False)
        with self._lock:
            self._listeners.append(ls)
            self._sel.register(ls, selectors.EVENT_READ, "listen")
        self._wake()

    def connect(self, ip: str, port: int) -> None:
        host = "127.0.0.1" if ip in ("*", "0.0.0.0", "") else ip
        with self._lock:
            self._pipes.append(_Pipe((host, int(port))))
        self._wake()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        deadline = time.monotonic() + LINGER_S
        while time.monotonic() < deadline:
            with self._lock:
                if not any(p.state == "ready" and (p.out or p.woff < len(p.wbuf))
                           for p in self._pipes):
                    break
            time.sleep(0.005)
        with self._lock:
            self._closing = True
            self._lock.notify_all()  # a blocked recv returns None
        self._wake()
        self._thread.join(timeout=10.0)
        for p in self._pipes:
            if p.sock is not None:
                p.sock.close()
        for ls in self._listeners:
            ls.close()
        self._sel.close()
        self._wake_r.close()
        self._wake_w.close()

    def peers(self) -> int:
        """Connections past their handshake."""
        with self._lock:
            return sum(1 for p in self._pipes if p.state == "ready")

    # ---------------------------------------------------------------- send
    def send_multipart(self, parts: list[bytes]) -> bool:
        """Queue one message; False when it was shed (queue full, no peer,
        or, for a ROUTER, an unknown identity). Never blocks."""
        if self.kind == SUB:
            raise ValueError("a SUB socket does not send messages")
        with self._lock:
            if self._closing:
                return False
            if self.kind == PUB:
                msg = encode_message(parts)
                topic = bytes(parts[0]) if parts else b""
                sent = False
                for p in self._pipes:
                    if p.state != "ready" or not any(topic.startswith(s) for s in p.subs):
                        continue
                    if len(p.out) >= self.hwm:
                        self.n_dropped += 1
                        continue
                    p.out.append(msg)
                    sent = True
                queued = sent
            elif self.kind == ROUTER:
                p = self._routes.get(bytes(parts[0]))
                if p is None:
                    self.n_unroutable += 1
                    return False
                if len(p.out) >= self.hwm:
                    self.n_dropped += 1
                    return False
                p.out.append(encode_message(parts[1:]))
                queued = True
            else:  # DEALER: round robin over connect endpoints and ready peers
                live = [p for p in self._pipes if p.addr is not None or p.state == "ready"]
                queued = False
                for k in range(len(live)):
                    p = live[(self._rr + k) % len(live)]
                    if len(p.out) < self.hwm:
                        p.out.append(encode_message(parts))
                        self._rr = (self._rr + k + 1) % len(live)
                        queued = True
                        break
                if not queued:
                    self.n_dropped += 1
            self._wake_locked()
        return queued

    # ---------------------------------------------------------------- recv
    def poll(self, timeout_ms: float | None = None) -> bool:
        """Whether a message is ready within ``timeout_ms`` (None = wait)."""
        with self._lock:
            if self._inbox:
                return True
            if timeout_ms is not None and timeout_ms <= 0:
                return False
            deadline = None if timeout_ms is None else time.monotonic() + timeout_ms / 1e3
            while not self._inbox and not self._closing:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._lock.wait(left)
            return bool(self._inbox)

    def recv_multipart(self, timeout_ms: float | None = None) -> list[bytes] | None:
        """The next message; None when none arrives within ``timeout_ms``
        (0 = do not wait, None = wait)."""
        if not self.poll(timeout_ms):
            return None
        with self._lock:
            if not self._inbox:
                return None
            msg = self._inbox.popleft()
            if len(self._inbox) == self.hwm - 1:
                self._wake_locked()  # reading may resume
            return msg

    # ------------------------------------------------------------ I/O thread
    def _wake(self) -> None:
        with self._lock:
            self._wake_locked()

    def _wake_locked(self) -> None:
        if not self._woken:
            self._woken = True
            try:
                self._wake_w.send(b"\0")
            except OSError:
                pass

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._closing:
                    return
                timeout = self._service()
            events = self._sel.select(timeout)
            with self._lock:
                if self._closing:
                    return
                for key, mask in events:
                    if key.data is None:
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except OSError:
                            pass
                        self._woken = False
                    elif key.data == "listen":
                        self._accept(key.fileobj)
                    else:
                        p = key.data
                        if p.sock is not key.fileobj:
                            continue
                        try:
                            if mask & selectors.EVENT_WRITE:
                                self._writable(p)
                            if mask & selectors.EVENT_READ and p.sock is not None:
                                self._readable(p)
                        except (OSError, ValueError):
                            # one broken connection must not stop the socket
                            self.n_protocol_errors += 1
                            self._drop(p)

    def _service(self) -> float | None:
        """Start due connects, fill write buffers and set every socket's
        interest; returns the select timeout."""
        now = time.monotonic()
        timeout = None
        full = len(self._inbox) >= self.hwm
        for p in self._pipes:
            if p.sock is None:
                if p.addr is None:
                    continue
                if now >= p.next_try:
                    self._start_connect(p, now)
                if p.sock is None:
                    wait = max(0.0, p.next_try - now)
                    timeout = wait if timeout is None else min(timeout, wait)
                    continue
            if p.state == "ready":
                self._fill(p)
            want = 0
            if p.state == "connecting" or p.woff < len(p.wbuf):
                want |= selectors.EVENT_WRITE
            if p.state != "connecting" and not full:
                want |= selectors.EVENT_READ
            fd = p.sock.fileno()
            have = self._interest.get(fd)
            if want != have:
                if have is None:
                    if want:
                        self._sel.register(p.sock, want, p)
                elif want:
                    self._sel.modify(p.sock, want, p)
                else:
                    self._sel.unregister(p.sock)
                if want:
                    self._interest[fd] = want
                else:
                    self._interest.pop(fd, None)
        return timeout

    def _fill(self, p: _Pipe) -> None:
        if p.woff and p.woff >= len(p.wbuf):
            p.wbuf = bytearray()
            p.woff = 0
        while p.out and len(p.wbuf) - p.woff < _WBUF_FILL:
            p.wbuf += p.out.popleft()

    def _start_connect(self, p: _Pipe, now: float) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rc = s.connect_ex(p.addr)
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK, errno.EAGAIN):
            s.close()
            p.next_try = now + RECONNECT_S
            return
        p.sock = s
        p.state = "connecting"

    def _accept(self, ls: socket.socket) -> None:
        while True:
            try:
                s, _ = ls.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            s.setblocking(False)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            p = _Pipe()
            p.sock = s
            self._begin(p)
            self._pipes.append(p)

    def _begin(self, p: _Pipe) -> None:
        p.state = "greeting"
        p.wbuf = bytearray(GREETING)
        p.woff = 0

    def _drop(self, p: _Pipe) -> None:
        """The connection is gone: a connect endpoint retries after
        ``RECONNECT_S``; an accepted peer is forgotten."""
        if p.sock is not None:
            fd = p.sock.fileno()
            if self._interest.pop(fd, None) is not None:
                try:
                    self._sel.unregister(p.sock)
                except (KeyError, ValueError):
                    pass
            p.sock.close()
        if p.routing_id is not None and self._routes.get(p.routing_id) is p:
            del self._routes[p.routing_id]
        if p.addr is None:
            if p in self._pipes:
                self._pipes.remove(p)
            return
        p.reset()
        if self.kind != DEALER:
            p.out.clear()  # a PUB's queue was for the old subscriptions
        p.next_try = time.monotonic() + RECONNECT_S

    def _writable(self, p: _Pipe) -> None:
        if p.state == "connecting":
            err = p.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self._drop(p)
                return
            self._begin(p)
        if p.state == "ready":
            self._fill(p)
        while p.woff < len(p.wbuf):
            try:
                n = p.sock.send(memoryview(p.wbuf)[p.woff:])
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._drop(p)
                return
            p.woff += n
            if p.state == "ready" and p.woff >= len(p.wbuf):
                self._fill(p)
        if p.woff >= len(p.wbuf):
            p.wbuf = bytearray()
            p.woff = 0

    def _readable(self, p: _Pipe) -> None:
        try:
            data = p.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(p)
            return
        if not data:
            self._drop(p)
            return
        p.rbuf += data
        try:
            self._parse(p)
        except ZmtpError:
            self.n_protocol_errors += 1
            self._drop(p)

    def _parse(self, p: _Pipe) -> None:
        buf = p.rbuf
        off = 0
        if p.state == "greeting":
            if len(buf) >= 1 and buf[0] != 0xFF:
                raise ZmtpError("not a ZMTP peer")
            if len(buf) < 64:
                return
            check_greeting(bytes(buf[:64]))
            off = 64
            p.state = "handshake"
            p.wbuf += ready_command(self.kind, self.identity)
        n = len(buf)
        while off + 2 <= n:
            flags = buf[off]
            if flags & _LONG:
                if off + 9 > n:
                    break
                size = int.from_bytes(buf[off + 1:off + 9], "big")
                head = 9
            else:
                size = buf[off + 1]
                head = 2
            if off + head + size > n:
                break
            body = bytes(buf[off + head:off + head + size])
            off += head + size
            if flags & _COMMAND:
                self._command(p, body)
                if p.sock is None:
                    return
            else:
                if p.state != "ready":
                    raise ZmtpError("message before READY")
                p.parts.append(body)
                if not flags & _MORE:
                    parts, p.parts = p.parts, []
                    self._deliver(p, parts)
        if off:
            del buf[:off]

    def _command(self, p: _Pipe, body: bytes) -> None:
        if not body:
            raise ZmtpError("empty command")
        n = body[0]
        name, data = body[1:1 + n], body[1 + n:]
        if name == b"READY":
            if p.state != "handshake":
                raise ZmtpError("READY twice")
            props = parse_properties(data)
            if props.get("socket-type", b"") not in _PEER_TYPES[self.kind]:
                raise ZmtpError(f"{self.kind} cannot talk to {props.get('socket-type')!r}")
            if self.kind == ROUTER:
                rid = props.get("identity") or b""
                if not rid:
                    self._next_id = (self._next_id + 1) & 0xFFFFFFFF
                    rid = b"\x00" + self._next_id.to_bytes(4, "big")
                if rid in self._routes:  # libzmq refuses a duplicate identity
                    raise ZmtpError("duplicate identity")
                p.routing_id = rid
                self._routes[rid] = p
            p.state = "ready"
            if self.kind == SUB:
                p.wbuf += frame(b"\x01")  # subscribe to everything (ZMTP 3.0 form)
        elif name == b"ERROR":
            raise ZmtpError(f"peer error {data[1:]!r}")

    def _deliver(self, p: _Pipe, parts: list[bytes]) -> None:
        if self.kind == PUB:
            if len(parts) == 1 and parts[0]:
                if parts[0][0] == 1:
                    p.subs.add(parts[0][1:])
                elif parts[0][0] == 0:
                    p.subs.discard(parts[0][1:])
            return
        if self.kind == ROUTER:
            parts = [p.routing_id, *parts]
        self._inbox.append(parts)
        self._lock.notify_all()
        if self.on_message is not None:
            self.on_message()
