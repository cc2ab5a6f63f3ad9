"""Fleet-side acting client — the port of ``tpu_rl.fleet.client``: replica
discovery, load-aware selection, hedged retries, failover, and the client
half of the version floor. Numpy and the standard library over the port's
:class:`~tpu_rl_torch.runtime.transport.Dealer`: no tensor, no card.

:class:`FleetClient` is call-compatible with
:class:`~tpu_rl_torch.runtime.inference_service.InferenceClient` (``act(obs,
first, retries)`` -> reply dict | None, ``close()``, ``n_rejected``,
``n_timeouts``, the ``inference-rtt`` timer record) so the worker's
remote-acting path swaps it in without touching the fallback state machine.
What changes underneath:

- **discovery**: one DEALER lane per replica endpoint, enumerated by
  :meth:`~tpu_rl_torch.config.MachinesConfig.inference_ports` (the checked,
  explicit port plan from Config);
- **selection**: power-of-two-choices over live lanes scored by an EWMA of
  observed RTT — two random candidates, pick the faster. O(1), no global
  state, provably near-best-of-N load spread;
- **hedging**: after ``Config.inference_hedge_ms`` without a reply the SAME
  seq is resent on a second lane; the first seq-matching reply wins and the
  loser's late duplicate is discarded (counted, exactly once). With
  ``inference_hedge_ms=0`` the hedge fires only at the full
  ``inference_timeout_ms`` boundary — plain failover;
- **failover**: a lane that times out is condemned and selection routes
  around it; when EVERY lane is dead the least-recently-condemned one is
  probed anyway, so a blip that condemned the whole fleet cannot strand
  the client forever;
- **re-probe**: condemned lanes (including never-answered ones — replica
  slots nothing serves yet) are re-probed on a doubling
  backoff (``Config.inference_reprobe_s`` doubling per consecutive silent
  probe up to ``inference_reprobe_max_s``). The probe piggybacks the SAME
  in-flight request on at most one overdue condemned lane per round — no
  extra latency, and if the probed replica answers it can even win the
  round. ANY reply on a lane revives it instantly, so replicas started or
  respawned after this client started are adopted without a restart;
- **version floor**: the highest ``ver`` this client ever accepted. Replies
  below the floor (a lagging replica still warming up after a join) are
  discarded while the wait continues, and the request is hedged onto
  another lane at once (one divergence from ``tpu_rl``, which waits for the
  hedge time: with ``inference_hedge_ms=0``, a whole timeout) — a client
  never observes weights older than ones it already saw, which with the replica's never-rollback
  swap closes the fleet's monotonicity guarantee end to end. The floor
  rides each request payload so servers/dashboards can see client pins.

``act`` returns None only once every attempt round has exhausted every
reachable lane — the worker's cue for local fallback, now meaning "the
FLEET is unreachable", not "one replica hiccupped".
"""

from __future__ import annotations

import random
import time
import uuid

import numpy as np

from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime.protocol import Protocol
from tpu_rl_torch.runtime.transport import Dealer
from tpu_rl_torch.utils.timer import ExecutionTimer


class _Lane:
    """One replica endpoint: its DEALER plus local health/latency state."""

    __slots__ = ("dealer", "ewma_ms", "dead_until", "fails", "sent", "ok")

    def __init__(self, dealer: Dealer):
        self.dealer = dealer
        self.ewma_ms = 0.0  # 0 = untried; untried lanes score best
        self.dead_until = 0.0  # monotonic instant the next probe is due
        self.fails = 0  # consecutive silent condemnations (backoff exponent)
        self.sent = 0
        self.ok = 0

    def observe(self, rtt_ms: float) -> None:
        self.ewma_ms = (
            rtt_ms if self.ewma_ms == 0.0
            else 0.8 * self.ewma_ms + 0.2 * rtt_ms
        )


class FleetClient:
    """Remote-acting client over N inference replicas."""

    def __init__(
        self,
        cfg: Config,
        endpoints: list[tuple[str, int]],
        wid: int = 0,
        timer: ExecutionTimer | None = None,
    ):
        if not endpoints:
            raise ValueError("FleetClient needs at least one endpoint")
        self.cfg = cfg
        self.wid = wid
        self.timer = timer
        self.seq = 0
        self.floor = -1  # highest accepted ver; requests carry it as "floor"
        self.n_timeouts = 0  # fully-exhausted rounds (all lanes, all waits)
        self.n_hedges = 0  # fleet-hedge-fired
        self.n_failovers = 0  # winning reply came from a non-primary lane
        self.n_dedups = 0  # fleet-dedup-replies: late/duplicate Act discarded
        self.n_floor_rejects = 0  # replies below the pinned version floor
        self.n_reprobes = 0  # fleet-reprobes: piggyback probes of dead lanes
        # Seeded per worker: deterministic lane choices under test, while
        # different workers still spread across replicas.
        self._rng = random.Random(0x5EED ^ (wid * 2654435761))
        self.lanes = [
            _Lane(Dealer(
                ip, port,
                identity=(
                    f"w{wid}-r{i}-{uuid.uuid4().hex[:8]}".encode()
                ),
            ))
            for i, (ip, port) in enumerate(endpoints)
        ]

    @classmethod
    def from_config(
        cls, cfg: Config, machines, wid: int = 0,
        timer: ExecutionTimer | None = None,
    ) -> "FleetClient":
        """Replica discovery: the fleet's endpoints are exactly the checked
        port plan ``MachinesConfig.inference_ports`` enumerates."""
        ports = machines.inference_ports(cfg)
        return cls(
            cfg, [(machines.learner_ip, p) for p in ports],
            wid=wid, timer=timer,
        )

    # ---------------------------------------------------------------- health
    @property
    def n_rejected(self) -> int:
        return sum(lane.dealer.n_rejected for lane in self.lanes)

    @property
    def n_live(self) -> int:
        now = time.monotonic()
        return sum(1 for lane in self.lanes if lane.dead_until <= now)

    def _pick(self, exclude: tuple[int, ...] = ()) -> int | None:
        """Power-of-two-choices over live, non-excluded lanes. A lane with
        ``fails > 0`` stays out of selection even after its backoff lapses —
        only the piggyback probe (or an unsolicited reply) readmits it, so
        real traffic is never routed to a lane that last answered nothing."""
        now = time.monotonic()
        live = [
            i for i, lane in enumerate(self.lanes)
            if i not in exclude and lane.fails == 0 and lane.dead_until <= now
        ]
        if not live:
            return None
        if len(live) == 1:
            return live[0]
        a, b = self._rng.sample(live, 2)
        return a if self.lanes[a].ewma_ms <= self.lanes[b].ewma_ms else b

    def _condemn(self, idx: int) -> None:
        """Bench a silent lane; consecutive condemnations double the wait
        before the next probe, capped at ``inference_reprobe_max_s``."""
        lane = self.lanes[idx]
        lane.fails += 1
        # The exponent is capped: past 1024 condemnations tpu_rl's float
        # power overflows.
        backoff = min(
            self.cfg.inference_reprobe_s * 2.0 ** min(lane.fails - 1, 32),
            self.cfg.inference_reprobe_max_s,
        )
        lane.dead_until = time.monotonic() + backoff

    def _revive(self, idx: int) -> None:
        """Any reply is proof of life: clear the bench and the backoff."""
        lane = self.lanes[idx]
        lane.fails = 0
        lane.dead_until = 0.0

    # ------------------------------------------------------------------- act
    def act(
        self,
        obs: np.ndarray,
        first: np.ndarray,
        retries: int | None = None,
    ) -> dict | None:
        cfg = self.cfg
        attempts = (
            cfg.inference_retries if retries is None else int(retries)
        ) + 1
        req = {
            "wid": self.wid, "seq": self.seq, "obs": obs, "first": first,
            "floor": self.floor,
        }
        t0 = time.perf_counter()
        try:
            for _attempt in range(attempts):
                payload = self._round(req, t0)
                if payload is not None:
                    return payload
            return None
        finally:
            self.seq += 1

    def _round(self, req: dict, t0: float) -> dict | None:
        """One attempt: primary send, optional hedge, first matching reply
        wins. None = this round exhausted its lanes; condemned the losers."""
        cfg = self.cfg
        # Sweep BEFORE selection: a late reply sitting in a condemned
        # lane's queue is proof of life and must revive the lane in time
        # for this round's pick, not the next one's.
        self._drain_stale()
        primary = self._pick()
        if primary is None:
            # Whole fleet condemned: probe the lane whose condemnation
            # lapses first rather than refusing outright — the client-side
            # guard against a transient blip stranding acting forever.
            primary = min(
                range(len(self.lanes)),
                key=lambda i: self.lanes[i].dead_until,
            )
        lanes_sent = [primary]
        self._send(primary, req)
        probed = self._maybe_probe(req, lanes_sent)
        hedge_s = cfg.inference_hedge_ms / 1e3
        timeout_s = cfg.inference_timeout_ms / 1e3
        start = time.perf_counter()
        deadline = start + timeout_s
        hedged = False
        extended = False
        answered: set[int] = set()
        while True:
            now = time.perf_counter()
            if not hedged and hedge_s > 0 and now - start >= hedge_s:
                hedged = self._hedge(req, lanes_sent)
            if now >= deadline:
                if not extended and not hedged:
                    # Timeout-boundary hedge (the hedge_ms=0 shape): one
                    # more lane, one more timeout window, then give up.
                    hedged = self._hedge(req, lanes_sent)
                    extended = True
                    if hedged:
                        self._condemn(primary)
                        deadline = now + timeout_s
                        continue
                for idx in lanes_sent:
                    # The probe lane was already re-condemned at send time;
                    # condemning it again would double its backoff twice.
                    if idx not in answered and idx != probed:
                        self._condemn(idx)
                self.n_timeouts += 1
                return None
            for idx in lanes_sent:
                got = self.lanes[idx].dealer.recv(timeout_ms=1)
                if got is None:
                    continue
                # Any frame at all is proof of life — a probed-back replica
                # (or one that merely answered slowly) rejoins selection.
                self._revive(idx)
                answered.add(idx)
                proto, payload = got
                if proto != Protocol.Act or not isinstance(payload, dict):
                    continue
                if payload.get("seq") != self.seq:
                    # A hedge loser's duplicate or an abandoned retry's
                    # ghost — discarded exactly once per frame.
                    self.n_dedups += 1
                    continue
                ver = int(payload.get("ver", -1))
                if ver < self.floor:
                    # Lagging replica (fresh join, broadcast not yet
                    # applied): refuse the stale weights, keep waiting for
                    # a floor-respecting lane. That lane has answered this
                    # seq and will not again, so the hedge goes out now
                    # (tpu_rl waits for the hedge time, with
                    # inference_hedge_ms=0 the whole timeout).
                    self.n_floor_rejects += 1
                    if not hedged:
                        hedged = self._hedge(req, lanes_sent)
                    continue
                self.floor = max(self.floor, ver)
                lane = self.lanes[idx]
                lane.ok += 1
                lane.observe((time.perf_counter() - t0) * 1e3)
                if idx != primary:
                    self.n_failovers += 1
                    if primary not in answered:
                        # The hedge beat a SILENT primary: condemn it now so
                        # the next round routes around it instead of eating
                        # another hedge window. (Its late reply, if any,
                        # revives it on the next drain.)
                        self._condemn(primary)
                if self.timer is not None:
                    self.timer.record(
                        "inference-rtt", time.perf_counter() - t0
                    )
                return payload

    def _maybe_probe(self, req: dict, lanes_sent: list[int]) -> int | None:
        """Piggyback re-probe: duplicate the in-flight request onto at most
        ONE condemned lane whose backoff has lapsed (the most overdue one).
        Costs nothing in latency — the round still rides its primary — and
        an answer both revives the lane and can win the round. Silent
        probes double the lane's backoff immediately so a replica slot that
        does not exist yet is bothered exponentially rarely."""
        now = time.monotonic()
        due = [
            i for i, lane in enumerate(self.lanes)
            if i not in lanes_sent and lane.fails > 0 and lane.dead_until <= now
        ]
        if not due:
            return None
        idx = min(due, key=lambda i: self.lanes[i].dead_until)
        self._send(idx, req)
        lanes_sent.append(idx)
        self.n_reprobes += 1
        # Assume silence: push the next probe out now. A reply (this round
        # or a later drain) revives the lane and clears the backoff.
        self._condemn(idx)
        return idx

    def _hedge(self, req: dict, lanes_sent: list[int]) -> bool:
        """Fire the duplicate request on a fresh lane; True if one existed."""
        idx = self._pick(exclude=tuple(lanes_sent))
        if idx is None:
            return False
        self._send(idx, req)
        lanes_sent.append(idx)
        self.n_hedges += 1
        return True

    def _send(self, idx: int, req: dict) -> None:
        lane = self.lanes[idx]
        lane.dealer.send(Protocol.ObsRequest, req)
        lane.sent += 1

    def _drain_stale(self) -> None:
        """Sweep every lane's queue before a fresh round: anything sitting
        there correlates to a PAST seq (hedge losers, post-timeout
        stragglers) and is discarded + counted — but it also proves the
        lane is alive, so the sweep revives it."""
        for i, lane in enumerate(self.lanes):
            for _ in range(64):
                got = lane.dealer.recv(timeout_ms=0)
                if got is None:
                    break
                self._revive(i)
                proto, payload = got
                if proto == Protocol.Act and isinstance(payload, dict):
                    self.n_dedups += 1

    def close(self) -> None:
        for lane in self.lanes:
            lane.dealer.close()
