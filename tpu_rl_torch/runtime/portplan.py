"""Shared, collision-checked port allocation for fleet-shaped deployments.

The port's own copy of ``tpu_rl.runtime.portplan``, unchanged in behaviour.

PR 12 grew the first explicit port plan (``MachinesConfig.inference_ports``:
N consecutive replica ports checked against the learner/model/telemetry/
manager ports). The population plane needs the same arithmetic — K member
telemetry ports, and per-member learner-port blocks for distributed
members — so the allocator lives here once and both planes call it. The
contract is unchanged from PR 12: a range that lands on a reserved port
fails at topology load with a named collision, not as an EADDRINUSE
minutes later inside a spawned child.

Pure stdlib and import-free of ``tpu_rl_torch.config`` (the ``MachinesConfig``
methods delegate here lazily; importing config back would cycle), so every
helper takes the topology duck-typed: anything with ``learner_port``,
``model_port`` and ``workers[*].port`` works.
"""

from __future__ import annotations


def reserved_ports(machines, cfg=None) -> dict[int, str]:
    """Port -> human-readable owner for every port the topology already
    claims. The owner string lands verbatim in collision errors, so it
    names the config knob to move, not just the number."""
    reserved = {
        machines.learner_port: "learner_port (rollout/stat fan-in)",
        machines.model_port: "model_port (weight broadcast)",
    }
    if cfg is not None and cfg.telemetry_port:
        reserved[cfg.telemetry_port] = "telemetry_port (HTTP exporter)"
    for w in machines.workers:
        reserved.setdefault(w.port, "worker manager port")
    return reserved


def plan_range(
    base: int, n: int, reserved: dict[int, str], what: str
) -> list[int]:
    """``n`` consecutive ports starting at ``base``, or ValueError naming
    the first collision / port-space overflow. ``what`` labels the range in
    errors (e.g. "inference replica", "population member telemetry")."""
    if not (0 < base and base + n <= 65536):
        raise ValueError(
            f"{what} ports [{base}, {base + n}) fall outside the port space"
        )
    ports = [base + i for i in range(n)]
    for p in ports:
        if p in reserved:
            raise ValueError(
                f"{what} port {p} (range [{base}, {base + n})) collides "
                f"with {reserved[p]}"
            )
    return ports


def plan_member_telemetry_ports(machines, cfg, k: int) -> list[int]:
    """Telemetry HTTP ports for K population members: the K ports after the
    controller's own ``telemetry_port``, collision-checked against the
    topology. When the plane is off (``telemetry_port == 0``) members
    export file-only snapshots (the controller scrapes
    ``member-<k>/telemetry.json``) and no sockets open: all zeros."""
    if not cfg.telemetry_port:
        return [0] * k
    reserved = reserved_ports(machines, cfg)
    return plan_range(
        cfg.telemetry_port + 1, k, reserved, "population member telemetry"
    )


def plan_member_port_blocks(
    machines, cfg, k: int, block: int = 8
) -> list[int]:
    """Base port of each distributed member's private port block: member i
    lays out its nested fleet (learner/model/inference/manager ports)
    inside ``[base_i, base_i + block)``. Blocks start after the outer
    topology's highest claimed port — including the K member telemetry
    ports, which count as claimed here — and are checked against every
    reserved port, so K nested fleets on one host never cross-bind."""
    reserved = reserved_ports(machines, cfg)
    for p in plan_member_telemetry_ports(machines, cfg, k):
        if p:
            reserved[p] = "population member telemetry port"
    first = max(reserved) + 1
    bases = []
    for i in range(k):
        base = first + i * block
        plan_range(base, block, reserved, f"population member-{i} block")
        bases.append(base)
    return bases
