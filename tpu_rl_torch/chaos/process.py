"""Process-level fault injection: one-shot SIGKILL/SIGSTOP on fleet children
— the port's own copy of ``tpu_rl.chaos.process``.

``ProcessChaos`` is polled from the supervisor loop, which is the only
place that knows every child's name and pid. Faults fire once, relative to
the first poll (fleet launch). A ``stop``/``hang`` leaves the child alive
to the OS but silent to the heartbeat plane — exactly the failure mode the
supervisor's silence-kill + escalation path must absorb (SIGTERM stays
pending on a stopped process; only SIGKILL clears it).
"""

from __future__ import annotations

import os
import signal
import time

from tpu_rl_torch.chaos.plan import Fault, FaultPlan


class ProcessChaos:
    def __init__(self, faults: list[Fault], clock=time.monotonic, kill=os.kill):
        self.faults = [f for f in faults if f.action in ("kill", "stop", "hang")]
        self._fired = [False] * len(self.faults)
        self._clock = clock
        self._kill = kill
        self._t0: float | None = None
        self.n_kills = 0
        self.n_stops = 0

    @classmethod
    def from_spec(cls, spec: str, **kw) -> "ProcessChaos":
        return cls(FaultPlan.parse(spec).process_faults(), **kw)

    def poll(self, children) -> list[tuple[str, str]]:
        """Fire due faults against live children; returns [(action, name)].

        A fault whose target has no live match (e.g. the child is mid
        respawn-backoff) stays armed and retries next poll.
        """
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        fired = []
        for i, f in enumerate(self.faults):
            if self._fired[i] or now - self._t0 < f.at_s:
                continue
            child = next(
                (
                    c
                    for c in children
                    if (c.name == f.target or c.name.startswith(f.target))
                    and c.proc is not None
                    and c.proc.is_alive()
                ),
                None,
            )
            if child is None:
                continue
            sig = signal.SIGKILL if f.action == "kill" else signal.SIGSTOP
            try:
                self._kill(child.proc.pid, sig)
            except (ProcessLookupError, OSError):
                continue  # raced with exit; retry next poll
            self._fired[i] = True
            if f.action == "kill":
                self.n_kills += 1
            else:
                self.n_stops += 1
            fired.append((f.action, child.name))
        return fired
