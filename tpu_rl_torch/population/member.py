"""Population member entry: one supervised child = one PBT member run — the
port of ``tpu_rl.population.member``.

Every member owns a directory under the controller's result dir::

    result_dir/member-<k>/
        config.json     Config.to_json — REWRITTEN atomically by the
                        controller on exploit (mutated hyperparameters)
        member.json     spawn-constant identity: {idx, seed, max_updates,
                        machines?} — never rewritten
        models/         the member's own checkpoint dir; exploit copies
                        from the winner land here as committed checkpoints
        telemetry.json  JsonExporter snapshot the controller scrapes

The entry re-reads both files on EVERY (re)start, which is what makes the
exploit step a plain process cycle: the controller stops the member,
copies the winner's checkpoint into ``models/``, rewrites ``config.json``
with the mutated values, and starts the child again — the respawned member
resumes from the copied checkpoint under the new hyperparameters. The same
property makes a kill safe at any moment (a crash, or ``tpu_rl``'s chaos
fault ``kill:member-1``, which the port's chaos plane will bring): the
supervisor's ordinary respawn runs this entry again, and two-phase
commit guarantees the newest COMMITTED checkpoint it resumes from is
whole, copied or not.

Colocated members run the port's :func:`colocated_main` (or, with
``sebulba_split``, :func:`sebulba_main`), each opening its own CUDA
context; distributed members run a full nested ``local_cluster`` fleet
inside their private port block.
"""

from __future__ import annotations

import json
import os
import time

from tpu_rl_torch.config import Config, MachinesConfig

# member.json filename (the spawn-constant half of the member state).
MEMBER_META = "member.json"


def write_member_meta(member_dir: str, meta: dict) -> None:
    """Atomic write of member.json (same tmp+replace discipline as
    Config.to_json — a respawning member must never read a torn file)."""
    path = os.path.join(member_dir, MEMBER_META)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def member_main(member_dir: str, stop_event, heartbeat) -> None:
    """Supervised child entry for one population member."""
    cfg = Config.from_json(os.path.join(member_dir, "config.json"))
    with open(os.path.join(member_dir, MEMBER_META)) as f:
        meta = json.load(f)
    seed = int(meta["seed"])
    max_updates = meta.get("max_updates")

    if cfg.env_mode == "colocated":
        if cfg.sebulba_split > 0:
            from tpu_rl_torch.runtime.sebulba import sebulba_main as child_main
        else:
            from tpu_rl_torch.runtime.runner import colocated_main as child_main

        child_main(cfg, stop_event, heartbeat, max_updates=max_updates, seed=seed)
        return

    # Distributed member: a nested fleet under its own supervisor, laid out
    # in the port block the controller planned (portplan). The member
    # process is pure orchestration — a drive loop that relays the outer
    # heartbeat and propagates the outer stop, the bounded variant of
    # Supervisor.loop().
    from tpu_rl_torch.runtime.runner import local_cluster

    machines = MachinesConfig.from_dict(meta.get("machines") or {})
    sup = local_cluster(cfg, machines, max_updates=max_updates, seed=seed)
    poll = max(0.2, cfg.supervise_poll_s)
    try:
        while not stop_event.is_set() and not sup.stop_event.is_set():
            sup.check()
            if heartbeat is not None:
                heartbeat.value = time.time()
            if any(
                not c.proc.is_alive() and c.proc.exitcode == 0
                and not c.respawn_at
                for c in sup.children
            ):
                break  # a role finished its bounded work (learner budget)
            if any(c.exhausted for c in sup.children):
                raise SystemExit(1)
            time.sleep(poll)
    finally:
        sup.stop()
