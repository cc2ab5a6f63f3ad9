"""Cluster launcher: fan the port's role processes out over machines — the
port of ``tpu_rl.launch``.

Per machine: an rsync of the code, then ssh into a detached tmux session
running the role's command (``python -m tpu_rl_torch <role>``), driven by
the machines topology, as the reference's ``run.py`` does. Commands are
argv lists (no shell string splicing), ``--dry-run`` prints the plan
instead of executing it, and the single-host path needs no ssh at all
(``python -m tpu_rl_torch local``).

Usage:
    python -m tpu_rl_torch.launch --machines machines.json [--params params.json]
        [--dry-run] [--ssh-user me] [--conda-env rl] [--population]
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess

from tpu_rl_torch.config import MachinesConfig

RSYNC_EXCLUDES = [
    ".git", "__pycache__", "results", "logs", "native/build",
]  # the reference run.py's exclude list, as tpu_rl's launcher keeps it


def _remote(cmd: str, host: str, user: str | None) -> list[str]:
    target = f"{user}@{host}" if user else host
    return ["ssh", "-o", "StrictHostKeyChecking=accept-new", target, cmd]


def _tmux_wrap(session: str, cmd: str) -> str:
    """Run ``cmd`` inside a detached tmux session (as the reference's run.py does)."""
    return (
        f"tmux kill-session -t {session} 2>/dev/null; "
        f"tmux new-session -d -s {session} {shlex.quote(cmd)}"
    )


def rsync_cmd(host: str, user: str | None, repo: str, dest: str) -> list[str]:
    target = f"{user}@{host}:{dest}" if user else f"{host}:{dest}"
    ex = [f"--exclude={e}" for e in RSYNC_EXCLUDES]
    return ["rsync", "-az", "--delete", *ex, repo + "/", target]


def role_cmd(
    role: str,
    machines_path: str,
    params_path: str | None,
    machine_idx: int | None = None,
    python: str = "python",
    conda_env: str | None = None,
    workdir: str = "~/tpu_rl_deploy",
) -> str:
    parts = [python, "-m", "tpu_rl_torch", role, "--machines", machines_path]
    if params_path:
        parts += ["--params", params_path]
    if machine_idx is not None:
        parts += ["--machine-idx", str(machine_idx)]
    cmd = " ".join(parts)
    if conda_env:  # the reference's conda activate
        cmd = f"conda activate {conda_env} && {cmd}"
    return f"cd {workdir} && {cmd}"


def plan(
    machines: MachinesConfig,
    machines_path: str,
    params_path: str | None,
    repo: str,
    ssh_user: str | None,
    conda_env: str | None,
    workdir: str = "~/tpu_rl_deploy",
    population: bool = False,
) -> list[list[str]]:
    """The full launch plan as a list of argv commands, in execution order:
    rsync to every machine, then learner, then per worker-machine a manager
    and the workers (the reference's run.py order). With ``population=True`` the
    learner host runs the PBT controller instead (``tpu_rl_torch.population``) —
    the controller supervises its K member fleets itself inside private
    port blocks, so no manager/worker fan-out is launched."""
    cmds: list[list[str]] = []
    hosts = (
        {machines.learner_ip}
        | {w.ip for w in machines.workers}
        | {w.manager_ip for w in machines.workers}  # manager may be a 3rd host
    )
    if population:
        cmds.append(rsync_cmd(machines.learner_ip, ssh_user, repo, workdir))
        cmds.append(
            _remote(
                _tmux_wrap(
                    "tpurl-population",
                    role_cmd("population", machines_path, params_path,
                             conda_env=conda_env, workdir=workdir),
                ),
                machines.learner_ip,
                ssh_user,
            )
        )
        return cmds
    for host in sorted(hosts):
        cmds.append(rsync_cmd(host, ssh_user, repo, workdir))
    cmds.append(
        _remote(
            _tmux_wrap(
                "tpurl-learner",
                role_cmd("learner", machines_path, params_path,
                         conda_env=conda_env, workdir=workdir),
            ),
            machines.learner_ip,
            ssh_user,
        )
    )
    for idx, w in enumerate(machines.workers):
        cmds.append(
            _remote(
                _tmux_wrap(
                    f"tpurl-manager-{idx}",
                    role_cmd("manager", machines_path, params_path, idx,
                             conda_env=conda_env, workdir=workdir),
                ),
                w.manager_ip,
                ssh_user,
            )
        )
        cmds.append(
            _remote(
                _tmux_wrap(
                    f"tpurl-worker-{idx}",
                    role_cmd("worker", machines_path, params_path, idx,
                             conda_env=conda_env, workdir=workdir),
                ),
                w.ip,
                ssh_user,
            )
        )
    return cmds


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpu_rl_torch.launch")
    p.add_argument("--machines", required=True)
    p.add_argument("--params")
    p.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--ssh-user")
    p.add_argument("--conda-env")
    p.add_argument("--workdir", default="~/tpu_rl_deploy")
    p.add_argument("--population", action="store_true",
                   help="launch the PBT controller on the learner host "
                   "instead of a single fleet (params must set pop_spec)")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)

    machines = MachinesConfig.from_json(args.machines)
    cmds = plan(
        machines, args.machines, args.params, args.repo,
        args.ssh_user, args.conda_env, args.workdir,
        population=args.population,
    )
    for cmd in cmds:
        print("$", " ".join(shlex.quote(c) for c in cmd))
        if not args.dry_run:
            subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
