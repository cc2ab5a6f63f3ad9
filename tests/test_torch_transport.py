"""The port's transport (``tpu_rl_torch.runtime.transport`` over
``runtime/zmtp.py``: ZMTP 3.0 on stdlib sockets) against ``tpu_rl``'s pyzmq
sockets on the wire, and its shared-memory channel against ``tpu_rl``'s.

- All four pairings exchange the same multipart messages: the port's PUB ->
  pyzmq SUB, pyzmq PUB -> the port's SUB, pyzmq DEALER <-> the port's
  ROUTER, the port's DEALER <-> pyzmq ROUTER (each side binding and
  connecting, as the runtime does).
- A connect before the peer binds retries in the background; so does a
  reconnect after the peer restarts.
- A PUB sheds the newest message at a subscriber's high-water mark and
  counts it; a ROUTER drops a reply to a vanished identity.
- ``ShmPub``/``ShmConsumer``/``FanInSub`` against ``tpu_rl``'s on one ring
  each way, and ``tests/test_shm_transport.py``'s cases on the port's
  classes.

Ports come from the OS (bind-checked blocks), never fixed numbers."""

import multiprocessing as mp
import os
import socket
import threading
import time

import numpy as np
import pytest
import zmq

from tpu_rl.runtime import transport as JT
from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime import zmtp
from tpu_rl_torch.runtime.manager import Manager
from tpu_rl_torch.runtime.protocol import (
    Protocol,
    decode,
    encode,
    make_trace_id,
    pack_trace,
    unpack_trace,
)
from tpu_rl_torch.runtime.transport import (
    Dealer,
    FanInSub,
    Pub,
    Router,
    ShmConsumer,
    ShmPub,
    Sub,
    is_loopback,
    make_data_pub,
    make_data_sub,
    use_shm,
)


def free_block(n: int = 1) -> int:
    """A base port whose ``n`` consecutive ports are all free."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                t = socket.socket()
                socks.append(t)
                t.bind(("0.0.0.0", p))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no free port block")


def small_config(**kw) -> Config:
    base = dict(hidden_size=16, seq_len=5, batch_size=8, buffer_size=32, obs_shape=(4,),
                action_space=2, time_horizon=32)
    base.update(kw)
    return Config.from_dict(base)


def wait_for(pred, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def messages(seed: int, n: int = 5) -> list[list[bytes]]:
    """Seeded multipart messages: protocol frames of several kinds and
    sizes (one past 255 bytes, one past 64 KiB), a traced 3-part frame and
    an empty part."""
    rng = np.random.default_rng(seed)
    out = [
        encode(Protocol.RolloutBatch, {"obs": rng.standard_normal((n, 4)).astype(np.float32)}),
        encode(Protocol.Stat, float(rng.random())),
        encode(Protocol.Model, {"actor": {"w": rng.standard_normal(20000).astype(np.float32)}}),
        encode(Protocol.Rollout, {"i": 1}, trace=pack_trace(2, 9, make_trace_id(2, 9), 5)),
        [b"x", b"", bytes(rng.integers(0, 255, 300, dtype=np.uint8))],
    ]
    return out


@pytest.fixture
def ctx():
    c = zmq.Context()
    yield c
    c.destroy(linger=0)


# ------------------------------------------------------------ PUB and SUB
@pytest.mark.timeout(60)
@pytest.mark.parametrize("bind", ["port-binds", "pyzmq-binds"])
def test_port_pub_to_pyzmq_sub(ctx, bind):
    port = free_block()
    zsub = ctx.socket(zmq.SUB)
    zsub.setsockopt(zmq.SUBSCRIBE, b"")
    if bind == "port-binds":
        pub = Pub("*", port, bind=True)
        zsub.connect(f"tcp://127.0.0.1:{port}")
    else:
        zsub.bind(f"tcp://*:{port}")
        pub = Pub("127.0.0.1", port, bind=False)
    try:
        # the SUB's subscription must reach the PUB first (slow joiner);
        # libzmq attaches a bound socket's new peer only when the socket is
        # called, hence the EVENTS reads
        assert wait_for(lambda: zsub.getsockopt(zmq.EVENTS) is not None and pub.sock.peers() == 1
                        and any(p.subs for p in pub.sock._pipes))
        sent = messages(1)
        for parts in sent:
            pub.send_raw(parts)
        got = [zsub.recv_multipart() if zsub.poll(5000) else None for _ in sent]
        assert got == sent
        proto, payload = JT.decode(got[0])
        assert proto == Protocol.RolloutBatch and payload["obs"].shape == (5, 4)
    finally:
        pub.close()
        zsub.close(linger=0)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("bind", ["port-binds", "pyzmq-binds"])
def test_pyzmq_pub_to_port_sub(ctx, bind):
    port = free_block()
    zpub = ctx.socket(zmq.PUB)
    if bind == "port-binds":
        sub = Sub("*", port, bind=True)
        zpub.connect(f"tcp://127.0.0.1:{port}")
    else:
        zpub.bind(f"tcp://*:{port}")
        sub = Sub("127.0.0.1", port, bind=False)
    try:
        sent = messages(2)
        got = None
        deadline = time.monotonic() + 10
        while got is None and time.monotonic() < deadline:  # slow joiner
            zpub.send_multipart(sent[0])
            got = sub.sock.recv_multipart(100)
        assert got == sent[0]
        for parts in sent[1:]:
            zpub.send_multipart(parts)
        rest = []
        while len(rest) < len(sent) - 1:
            msg = sub.sock.recv_multipart(5000)
            assert msg is not None
            if msg != sent[0]:  # late duplicates of the probe
                rest.append(msg)
        assert rest == sent[1:]
        # the decoding surface: a garbage frame is counted, never raised
        zpub.send_multipart([b"\xfa", b"junk"])
        assert sub.recv(timeout_ms=5000) is None and sub.n_rejected == 1
    finally:
        sub.close()
        zpub.close(linger=0)


# ------------------------------------------------------- ROUTER and DEALER
@pytest.mark.timeout(60)
def test_pyzmq_dealer_to_port_router(ctx):
    port = free_block()
    router = Router("*", port, bind=True)
    dealers = []
    try:
        for i, ident in enumerate([b"w0-abc", None]):
            d = ctx.socket(zmq.DEALER)
            if ident is not None:
                d.setsockopt(zmq.IDENTITY, ident)
            d.connect(f"tcp://127.0.0.1:{port}")
            dealers.append(d)
        for i, d in enumerate(dealers):
            d.send_multipart(JT.encode(Protocol.ObsRequest, {"wid": i, "seq": 0}))
        got = [router.recv(timeout_ms=5000) for _ in dealers]
        assert all(g is not None for g in got)
        by_wid = {g[2]["wid"]: g for g in got}
        assert by_wid[0][0] == b"w0-abc"
        assert len(by_wid[1][0]) == 5 and by_wid[1][0][0] == 0  # libzmq's generated form
        for wid, (ident, _proto, _payload) in by_wid.items():
            router.send(ident, Protocol.Act, {"seq": 0, "wid": wid})
        for i, d in enumerate(dealers):
            assert d.poll(5000)
            proto, payload = JT.decode(d.recv_multipart())
            assert proto == Protocol.Act and payload == {"seq": 0, "wid": i}
        # a reply to a vanished identity is dropped, as libzmq's ROUTER does
        router.send(b"nobody", Protocol.Act, {"seq": 1})
        assert router.sock.n_unroutable == 1
    finally:
        router.close()
        for d in dealers:
            d.close(linger=0)


@pytest.mark.timeout(60)
def test_port_dealer_to_pyzmq_router(ctx):
    port = free_block()
    zr = ctx.socket(zmq.ROUTER)
    zr.bind(f"tcp://*:{port}")
    dealer = Dealer("127.0.0.1", port, identity=b"w1-xyz")
    try:
        sent = messages(3)
        for parts in sent:
            dealer.sock.send_multipart(parts)
        got = [zr.recv_multipart() if zr.poll(5000) else None for _ in sent]
        assert [g[0] for g in got] == [b"w1-xyz"] * len(sent)
        assert [g[1:] for g in got] == sent
        zr.send_multipart([b"w1-xyz", *JT.encode(Protocol.Act, {"seq": 4})])
        assert dealer.recv(timeout_ms=5000) == (Protocol.Act, {"seq": 4})
    finally:
        dealer.close()
        zr.close(linger=0)


# ----------------------------------------------- connect order and restart
@pytest.mark.timeout(60)
def test_connect_before_bind_and_peer_restart(ctx):
    """The port's DEALER and SUB connect to ports nobody binds yet; their
    queued request and the PUB's stream arrive once pyzmq binds; both
    reconnect after the pyzmq peers are closed and bound again."""
    port = free_block(2)
    dealer = Dealer("127.0.0.1", port, identity=b"early")
    sub = Sub("127.0.0.1", port + 1, bind=False)
    try:
        dealer.send(Protocol.ObsRequest, {"seq": 1})
        time.sleep(0.3)  # retries run in the background meanwhile
        for generation in range(2):
            zr = ctx.socket(zmq.ROUTER)
            zr.bind(f"tcp://*:{port}")
            zp = ctx.socket(zmq.PUB)
            zp.bind(f"tcp://*:{port + 1}")
            if generation == 1:
                dealer.send(Protocol.ObsRequest, {"seq": 2})
            assert zr.poll(10000), f"generation {generation}: no request arrived"
            ident, *parts = zr.recv_multipart()
            assert ident == b"early" and JT.decode(parts)[1]["seq"] == generation + 1
            zr.send_multipart([ident, *JT.encode(Protocol.Act, {"seq": generation + 1})])
            assert dealer.recv(timeout_ms=5000)[1] == {"seq": generation + 1}
            got = None
            deadline = time.monotonic() + 10
            while got is None and time.monotonic() < deadline:
                zp.send_multipart(JT.encode(Protocol.Stat, float(generation)))
                got = sub.recv(timeout_ms=100)
            assert got == (Protocol.Stat, float(generation))
            zr.close(linger=0)
            zp.close(linger=0)
            time.sleep(0.2)  # the peer is gone; the port's sockets reconnect
    finally:
        dealer.close()
        sub.close()


# ------------------------------------------------------------- high water
@pytest.mark.timeout(60)
def test_pub_sheds_newest_at_hwm_and_counts(ctx):
    port = free_block()
    pub = Pub("*", port, bind=True, hwm=4)
    zsub = ctx.socket(zmq.SUB)
    zsub.setsockopt(zmq.RCVHWM, 1)
    zsub.setsockopt(zmq.RCVBUF, 4096)
    zsub.setsockopt(zmq.SUBSCRIBE, b"")
    zsub.connect(f"tcp://127.0.0.1:{port}")
    try:
        assert wait_for(lambda: any(p.subs for p in pub.sock._pipes))
        big = [b"\x03", os.urandom(1 << 16)]
        n = 400  # 26 MB against a subscriber that reads nothing
        for _ in range(n):
            pub.send_raw(big)
        assert wait_for(lambda: pub.n_dropped > 0, 10)
        dropped = pub.n_dropped
        got = 0
        while zsub.poll(2000):
            assert zsub.recv_multipart() == big  # survivors intact
            got += 1
        assert got + dropped <= n and dropped > 0 and got > 0
    finally:
        pub.close()
        zsub.close(linger=0)


def test_greeting_and_ready_bytes():
    """The wire details that break silently: the 64-byte greeting (as-server
    0, zero filler), the READY command with its properties, LONG frames."""
    g = zmtp.GREETING
    assert len(g) == 64 and g[0] == 0xFF and g[9] == 0x7F and g[10:12] == b"\x03\x00"
    assert g[12:16] == b"NULL" and g[32] == 0 and g[33:] == bytes(31)
    ready = zmtp.ready_command("DEALER", b"id")
    assert ready[0] == 0x04 and ready[2:8] == b"\x05READY"
    props = zmtp.parse_properties(ready[8:])
    assert props == {"socket-type": b"DEALER", "identity": b"id"}
    assert zmtp.encode_message([b"a" * 300])[:9] == b"\x02" + (300).to_bytes(8, "big")
    assert zmtp.encode_message([b"a", b"b"]) == b"\x01\x01a\x00\x01b"


@pytest.mark.timeout(30)
def test_incompatible_peer_is_refused(ctx):
    """A pyzmq PUSH cannot talk to the port's SUB: the handshake fails and
    nothing is delivered."""
    port = free_block()
    sub = Sub("*", port, bind=True)
    push = ctx.socket(zmq.PUSH)
    push.connect(f"tcp://127.0.0.1:{port}")
    try:
        push.send_multipart([b"\x02", b"x"], zmq.NOBLOCK) if push.poll(200, zmq.POLLOUT) else None
        assert sub.recv(timeout_ms=500) is None
        assert wait_for(lambda: sub.sock.n_protocol_errors >= 1, 5)
    finally:
        sub.close()
        push.close(linger=0)


# ------------------------------------------------- shm channel across packages
@pytest.mark.timeout(60)
@pytest.mark.parametrize("direction", ["tpu_rl-to-port", "port-to-tpu_rl"])
def test_shm_ring_across_packages(direction):
    port = free_block()
    sent = messages(4)
    if direction == "tpu_rl-to-port":
        con, pub = ShmConsumer(port), JT.ShmPub(port)
    else:
        con, pub = JT.ShmConsumer(port), ShmPub(port)
    try:
        for parts in sent:
            pub.send_raw(parts)
        got = _drain_until(con, len(sent))
        assert got == sent
    finally:
        pub.close()
        con.close()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("direction", ["tpu_rl-to-port", "port-to-tpu_rl"])
def test_fanin_across_packages(direction):
    """tpu_rl's producers (shm and pyzmq TCP) into the port's FanInSub, and
    the port's into tpu_rl's."""
    port = free_block()
    if direction == "tpu_rl-to-port":
        sub, shm_pub, tcp_pub = FanInSub("*", port), JT.ShmPub(port), JT.Pub("127.0.0.1", port, bind=False)
    else:
        sub, shm_pub, tcp_pub = JT.FanInSub("*", port), ShmPub(port), Pub("127.0.0.1", port, bind=False)
    try:
        got = {}
        deadline = time.time() + 30
        while len(got) < 2 and time.time() < deadline:
            tcp_pub.send(Protocol.RolloutBatch, {"via": "tcp"})
            shm_pub.send(Protocol.RolloutBatch, {"via": "shm"})
            for proto, payload, _ in sub.drain_traced():
                got[payload["via"]] = int(proto)
            time.sleep(0.01)
        assert got == {"tcp": 3, "shm": 3}
    finally:
        tcp_pub.close()
        shm_pub.close()
        sub.close()


# --------------------------- tests/test_shm_transport.py on the port's classes
def _frame(payload=None, proto=Protocol.RolloutBatch, trace=None):
    return encode(proto, payload if payload is not None else {"x": 1}, trace=trace)


def _drain_until(consumer, n, timeout=10.0):
    out = []
    deadline = time.time() + timeout
    while len(out) < n and time.time() < deadline:
        out.extend(consumer.drain_frames())
        if len(out) < n:
            time.sleep(0.001)
    return out


def test_shm_loopback_byte_identical():
    port = free_block()
    con, pub = ShmConsumer(port), ShmPub(port)
    try:
        sent = [
            _frame({"obs": np.arange(64, dtype=np.float32)}),
            _frame({"i": 2}, Protocol.Stat),
            _frame({"t": 3}, Protocol.Rollout, trace=pack_trace(1, 2, make_trace_id(1, 2), 99)),
        ]
        for parts in sent:
            pub.send_raw(parts)
        assert _drain_until(con, len(sent)) == sent
        assert pub.n_dropped_full == 0 and pub.n_dropped_no_peer == 0
    finally:
        pub.close()
        con.close()


def test_shm_multi_producer_fan_in():
    port = free_block()
    con = ShmConsumer(port)
    pubs = [ShmPub(port) for _ in range(3)]
    try:
        assert sorted(p.slot for p in pubs) == [0, 1, 2]
        for k, p in enumerate(pubs):
            p.send_raw(_frame({"producer": k}))
        got = _drain_until(con, 3)
        assert {decode(f)[1]["producer"] for f in got} == {0, 1, 2}
    finally:
        for p in pubs:
            p.close()
        con.close()


def test_shm_ring_wraparound_preserves_frames():
    port = free_block()
    con = ShmConsumer(port, capacity=1 << 16)
    pub = ShmPub(port)
    try:
        payloads = [np.full(2048, i, dtype=np.float32) for i in range(64)]
        got = []
        for i, arr in enumerate(payloads):
            pub.send_raw(_frame({"i": i, "a": arr}))
            got.extend(con.drain_frames())
        got.extend(_drain_until(con, len(payloads) - len(got), timeout=5))
        assert pub.n_dropped_full == 0 and con.n_resync == 0
        decoded = [decode(f)[1] for f in got]
        assert [d["i"] for d in decoded] == list(range(64))
        for i, d in enumerate(decoded):
            np.testing.assert_array_equal(d["a"], payloads[i])
    finally:
        pub.close()
        con.close()


def test_shm_full_ring_drops_newest_and_counts():
    port = free_block()
    con = ShmConsumer(port, capacity=1 << 13)
    pub = ShmPub(port)
    try:
        big = _frame({"a": os.urandom(2048)})
        for _ in range(16):
            pub.send_raw(big)
        assert pub.n_dropped_full > 0
        got = _drain_until(con, 16 - pub.n_dropped_full)
        assert got and all(f == big for f in got)
        assert len(got) + pub.n_dropped_full == 16
    finally:
        pub.close()
        con.close()


def test_shm_no_consumer_counts_drops_without_raising():
    port = free_block()
    pub = ShmPub(port)
    try:
        for _ in range(3):
            pub.send_raw(_frame())
        assert pub.n_dropped_no_peer == 3
    finally:
        pub.close()


@pytest.mark.timeout(60)
def test_shm_consumer_restart_rerendezvous():
    port = free_block()
    con, pub = ShmConsumer(port), ShmPub(port)
    try:
        pub.send_raw(_frame({"gen": 0}))
        assert _drain_until(con, 1)
        con.close()
        con = ShmConsumer(port)
        got = []
        deadline = time.time() + 30
        while not got and time.time() < deadline:
            pub.send_raw(_frame({"gen": 1}))
            got = con.drain_frames()
            time.sleep(0.05)
        assert got, "producer never re-rendezvoused"
        assert decode(got[-1])[1] == {"gen": 1}
    finally:
        pub.close()
        con.close()


def test_shm_close_unlinks_segments():
    port = free_block()
    con, pub = ShmConsumer(port), ShmPub(port)
    pub.send_raw(_frame())
    pub.close()
    con.close()
    assert [f for f in os.listdir("/dev/shm") if f.startswith(f"tpurl-{port}-")] == []


def _hammer(port, n, ready):
    pub = ShmPub(port)
    ready.wait(10)
    sent = 0
    deadline = time.monotonic() + 60
    while sent < n and time.monotonic() < deadline:
        before = pub.n_dropped_full + pub.n_dropped_no_peer
        pub.send_raw(encode(Protocol.RolloutBatch, {"i": sent}))
        if pub.n_dropped_full + pub.n_dropped_no_peer == before:
            sent += 1
        else:
            time.sleep(0.0005)
    pub.close()
    os._exit(0 if sent == n else 1)


@pytest.mark.timeout(120)
def test_shm_cross_process_seqlock_under_contention():
    port = free_block()
    n = 2000
    con = ShmConsumer(port, capacity=1 << 20)
    c = mp.get_context("fork")
    ready = c.Event()
    proc = c.Process(target=_hammer, args=(port, n, ready), daemon=True)
    proc.start()
    try:
        ready.set()
        got = _drain_until(con, n, timeout=60)
        proc.join(30)
        assert proc.exitcode == 0, "producer timed out re-sending drops"
        assert con.n_resync == 0
        assert [decode(f)[1]["i"] for f in got] == list(range(n))
    finally:
        proc.terminate()
        con.close()


def test_fanin_traced_roundtrip_and_garbage_rejection():
    port = free_block()
    sub, pub = FanInSub("*", port, bind=True), ShmPub(port)
    try:
        trailer = pack_trace(3, 41, make_trace_id(3, 41), 7_000)
        pub.send_raw(_frame({"k": 5}, Protocol.Rollout, trace=trailer))
        got = sub.recv_traced(timeout_ms=5000)
        assert got is not None
        proto, payload, trl = got
        assert proto == Protocol.Rollout and payload == {"k": 5}
        assert unpack_trace(trl) == (3, 41, make_trace_id(3, 41), 7_000)
        assert sub.n_rejected == 0
        pub.send_raw([b"\xfa", b"garbage frame"])
        assert sub.recv_traced(timeout_ms=300) is None
        assert sub.n_rejected == 1
    finally:
        pub.close()
        sub.close()


@pytest.mark.timeout(60)
def test_fanin_chaos_corrupt_accounting_over_shm():
    """tpu_rl's chaos shim on the port's FanInSub: every injected corruption
    yields exactly one n_rejected on the shm path."""
    from tests.conftest import small_config as jax_small_config
    from tpu_rl.chaos import maybe_transport_chaos

    cfg = jax_small_config(chaos_spec="corrupt:rollout@p=1.0", chaos_seed=11, transport="shm")
    chaos = maybe_transport_chaos(cfg, "storage")
    port = free_block()
    sub, pub = FanInSub("*", port, bind=True, chaos=chaos), ShmPub(port)
    try:
        n_sent = 8
        for i in range(n_sent):
            pub.send(Protocol.Rollout, {"i": i})
        got = [sub.recv_traced(timeout_ms=2000) for _ in range(n_sent)]
        assert got == [None] * n_sent
        assert sub.n_rejected == chaos.n_corrupted == n_sent
        pub.send(Protocol.Stat, 3.5)
        msg = sub.recv_traced(timeout_ms=2000)
        assert msg is not None and msg[0] == Protocol.Stat
        assert sub.n_rejected == chaos.n_corrupted == n_sent
    finally:
        pub.close()
        sub.close()


def test_shm_pub_applies_chaos_on_send():
    from tpu_rl.chaos.inject import TransportChaos
    from tpu_rl.chaos.plan import Fault

    chaos = TransportChaos(
        [Fault("drop", "rollout", p=1.0, protos=frozenset({1, 3}), direction="send",
               site="manager")], [], seed=3)
    port = free_block()
    con, pub = ShmConsumer(port), ShmPub(port, chaos=chaos)
    try:
        for i in range(5):
            pub.send(Protocol.Rollout, {"i": i})
        assert chaos.n_dropped == 5
        time.sleep(0.05)
        assert con.drain_frames() == []
    finally:
        pub.close()
        con.close()


def test_selection():
    for ip in ("127.0.0.1", "localhost", "::1", "*", "0.0.0.0"):
        assert is_loopback(ip)
    assert not is_loopback("10.0.0.7")
    assert not use_shm(small_config(), "127.0.0.1")
    assert use_shm(small_config(transport="shm"), "10.0.0.7")
    assert use_shm(small_config(transport="auto"), "127.0.0.1")
    assert not use_shm(small_config(transport="auto"), "10.0.0.7")
    port = free_block(2)
    for cfg, want_sub, want_pub, p in ((small_config(), Sub, Pub, port),
                                       (small_config(transport="shm"), FanInSub, ShmPub, port + 1)):
        sub = make_data_sub(cfg, "*", p, bind=True)
        pub = make_data_pub(cfg, "127.0.0.1", p, bind=False)
        assert type(sub) is want_sub and type(pub) is want_pub
        sub.close()
        pub.close()
    with pytest.raises(AssertionError):
        small_config(transport="carrier-pigeon")


def test_cli_transport_override():
    from tpu_rl_torch.__main__ import build_parser, load_config

    cfg, _ = load_config(build_parser().parse_args(["local", "--transport", "shm"]))
    assert cfg.transport == "shm"
    cfg, _ = load_config(build_parser().parse_args(["local"]))
    assert cfg.transport == "tcp"


@pytest.mark.timeout(120)
def test_manager_relays_tcp_workers_onto_shm_hop_byte_identical():
    port = free_block(2)
    worker_port, learner_port = port, port + 1
    cfg = small_config(relay_mode="raw", transport="shm")
    sink = make_data_sub(cfg, "*", learner_port, bind=True)
    assert type(sink) is FanInSub
    stop = threading.Event()
    m = Manager(cfg, worker_port, "127.0.0.1", learner_port, stop_event=stop)
    t = threading.Thread(target=m.run, daemon=True)
    t.start()
    pub = Pub("127.0.0.1", worker_port, bind=False)
    trailer = pack_trace(3, 41, make_trace_id(3, 41), 123_456_789)
    sent = _frame({"obs": np.arange(16, dtype=np.float32)}, Protocol.RolloutBatch, trace=trailer)
    try:
        got = None
        deadline = time.time() + 60
        while time.time() < deadline and got is None:
            pub.send_raw(sent)
            got = sink.recv_raw(timeout_ms=200)
        assert got is not None, "relay never forwarded the traced frame"
        assert got[1] == sent
        pub.send_raw([b"\xfa", b"not a frame"])
        sent2 = _frame({"phase": "post"}, Protocol.RolloutBatch, trace=trailer)
        got2 = None
        deadline = time.time() + 60
        while time.time() < deadline and got2 is None:
            pub.send_raw(sent2)
            got2 = sink.recv_raw(timeout_ms=200)
            if got2 is not None and got2[1][1] == sent[1]:
                got2 = None
        assert got2 is not None, "relay died after the garbage frame"
        assert got2[1] == sent2
        assert t.is_alive()
    finally:
        stop.set()
        t.join(timeout=30)
        pub.close()
        sink.close()
    assert not t.is_alive()


# --------------------------------------------------- asyncio and the client
@pytest.mark.timeout(60)
def test_async_sub_and_pub_against_pyzmq(ctx):
    """AsyncSub wakes on the I/O thread's arrival callback; AsyncPub's send
    reaches a pyzmq SUB."""
    import asyncio

    from tpu_rl_torch.runtime.transport import AsyncPub, AsyncSub

    port = free_block(2)
    zpub = ctx.socket(zmq.PUB)
    zpub.bind(f"tcp://*:{port}")
    zsub = ctx.socket(zmq.SUB)
    zsub.setsockopt(zmq.SUBSCRIBE, b"")
    zsub.connect(f"tcp://127.0.0.1:{port + 1}")
    sub = AsyncSub("127.0.0.1", port, bind=False)
    pub = AsyncPub("*", port + 1, bind=True)

    async def main():
        async def feed():
            for _ in range(200):  # slow joiner: resend until received
                zpub.send_multipart(JT.encode(Protocol.Stat, 1.5))
                await asyncio.sleep(0.02)

        task = asyncio.ensure_future(feed())
        got = await asyncio.wait_for(sub.recv(), 10)
        task.cancel()
        return got

    try:
        assert asyncio.run(main()) == (Protocol.Stat, 1.5)
        assert wait_for(lambda: zsub.getsockopt(zmq.EVENTS) is not None
                        and any(p.subs for p in pub.sock._pipes))
        asyncio.run(pub.send(Protocol.Stat, 2.5))
        assert zsub.poll(5000) and JT.decode(zsub.recv_multipart()) == (Protocol.Stat, 2.5)
    finally:
        sub.close()
        pub.close()
        zpub.close(linger=0)
        zsub.close(linger=0)


@pytest.mark.timeout(60)
def test_inference_client_times_out_then_is_served(ctx):
    """No server: ``act`` returns None after 1 + retries timeouts (the
    worker's cue to act locally). A pyzmq ROUTER answering by seq: the
    client gets its reply and skips a stale seq."""
    from tpu_rl_torch.runtime.inference_service import InferenceClient

    port = free_block()
    cfg = small_config(inference_timeout_ms=100, inference_retries=1)
    client = InferenceClient(cfg, "127.0.0.1", port, wid=3)
    obs, first = np.zeros((2, 4), np.float32), np.ones(2, np.float32)
    try:
        t0 = time.perf_counter()
        assert client.act(obs, first) is None
        assert client.n_timeouts == 2 and time.perf_counter() - t0 >= 0.18  # two 100 ms waits
        zr = ctx.socket(zmq.ROUTER)
        zr.bind(f"tcp://*:{port}")

        def serve():
            for _ in range(3):  # the two ghosts of the timed-out seq, then seq 1
                if not zr.poll(5000):
                    return
                ident, *parts = zr.recv_multipart()
                req = JT.decode(parts)[1]
                zr.send_multipart([ident, *JT.encode(Protocol.Act, {"seq": req["seq"] - 1})])
                zr.send_multipart([ident, *JT.encode(Protocol.Act, {"seq": req["seq"], "ok": 1})])

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        cfg2 = small_config(inference_timeout_ms=5000, inference_retries=0)
        client.cfg = cfg2
        reply = client.act(obs, first)
        assert reply is not None and reply["seq"] == 1 and reply["ok"] == 1
        t.join(10)
        zr.close(linger=0)
    finally:
        client.close()
