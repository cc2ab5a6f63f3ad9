"""In-process stand-in for the ROUTER/DEALER pair of ``tpu_rl.runtime.transport``.

:class:`LocalRouter` is the server side: ``recv``, ``drain`` and ``send``
carry the same ``(identity, Protocol, payload-dict)`` tuples a ZMQ
``Router`` yields, through thread-safe queues instead of a socket.
:meth:`LocalRouter.client` hands out one :class:`LocalClient` per identity.
Payloads are passed by reference, not serialized: a sender must not mutate
what it sent. The ZMQ wire comes with the distributed slice of the port.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np

from tpu_rl_torch.runtime.protocol import Protocol


def _timeout_s(timeout_ms: float | None) -> float | None:
    return None if timeout_ms is None else max(0.0, timeout_ms) / 1e3


class LocalRouter:
    def __init__(self) -> None:
        self._inbox: queue.Queue = queue.Queue()
        self._outboxes: dict[bytes, queue.Queue] = {}
        self._lock = threading.Lock()

    def recv(self, timeout_ms: float | None = None) -> tuple[bytes, Protocol, Any] | None:
        """One ``(identity, proto, payload)`` request, or None on timeout.
        ``timeout_ms`` may be fractional; 0 polls without waiting."""
        try:
            if timeout_ms is not None and timeout_ms <= 0:
                return self._inbox.get_nowait()
            return self._inbox.get(timeout=_timeout_s(timeout_ms))
        except queue.Empty:
            return None

    def drain(self, max_msgs: int = 1024) -> Iterator[tuple[bytes, Protocol, Any]]:
        """Yield every queued request, at most ``max_msgs``."""
        for _ in range(max_msgs):
            try:
                yield self._inbox.get_nowait()
            except queue.Empty:
                return

    def send(self, identity: bytes, proto: Protocol, payload: Any) -> None:
        """Route one reply to ``identity``; a reply to an identity that never
        connected is dropped, as ZMQ drops it."""
        box = self._outboxes.get(identity)
        if box is not None:
            box.put((proto, payload))

    def client(self, identity: bytes) -> "LocalClient":
        with self._lock:
            box = self._outboxes.setdefault(identity, queue.Queue())
        return LocalClient(self, identity, box)


class LocalClient:
    """The DEALER side for one identity."""

    def __init__(self, router: LocalRouter, identity: bytes, box: queue.Queue):
        self.router = router
        self.identity = identity
        self._box = box
        self.seq = 0

    def send(self, proto: Protocol, payload: Any) -> None:
        self.router._inbox.put((self.identity, proto, payload))

    def recv(self, timeout_ms: float | None = None) -> tuple[Protocol, Any] | None:
        try:
            return self._box.get(timeout=_timeout_s(timeout_ms))
        except queue.Empty:
            return None

    def act(
        self, obs: np.ndarray, first: np.ndarray, timeout_ms: float = 30_000.0
    ) -> dict | None:
        """One ObsRequest/Act round trip, correlated by ``seq``; None when no
        matching reply arrives within ``timeout_ms``."""
        seq = self.seq
        self.seq += 1
        self.send(Protocol.ObsRequest, {"seq": seq, "obs": obs, "first": first})
        while True:
            got = self.recv(timeout_ms)
            if got is None:
                return None
            proto, payload = got
            if proto == Protocol.Act and isinstance(payload, dict) and payload.get("seq") == seq:
                return payload
