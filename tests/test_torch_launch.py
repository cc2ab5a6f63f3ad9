"""The port's launcher (``tpu_rl_torch.launch``) against ``tpu_rl``'s: the
plan's commands equal ``tpu_rl``'s with ``tpu_rl`` -> ``tpu_rl_torch`` in
the role commands, for fleets and populations; and the plan executes, as
``tests/test_launch_execute.py`` runs ``tpu_rl``'s: the unmodified plan
through the POSIX stand-ins of ``tests/fakebin`` (ssh runs the command
through sh on loopback, rsync mirrors the tree, tmux detaches each role
with a pidfile), the port's roles coming up inside the deployed copy."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests.test_torch_transport import free_block
from tpu_rl import launch as jax_launch
from tpu_rl.config import MachinesConfig as JaxMachines
from tpu_rl_torch import launch
from tpu_rl_torch.config import MachinesConfig

REPO = Path(__file__).resolve().parent.parent
FAKEBIN = REPO / "tests" / "fakebin"

TOPOLOGIES = {
    "one-host": {"learner": {"ip": "127.0.0.1", "port": 40000},
                 "workers": [{"num_p": 2, "ip": "127.0.0.1", "manager_ip": "127.0.0.1",
                              "port": 40010}]},
    "three-hosts": {"learner": {"ip": "10.0.0.1", "port": 40000},
                    "workers": [{"num_p": 4, "ip": "10.0.0.2", "manager_ip": "10.0.0.3",
                                 "port": 40010},
                                {"num_p": 1, "ip": "10.0.0.4", "manager_ip": "10.0.0.4",
                                 "port": 40011}]},
}


def _port_of(cmd: list[str]) -> list[str]:
    """tpu_rl's command with the role module renamed (``-m tpu_rl <role>``)."""
    return [c.replace("-m tpu_rl ", "-m tpu_rl_torch ") for c in cmd]


@pytest.mark.parametrize("population", [False, True])
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("user,conda", [(None, None), ("me", "rl")])
def test_plan_equals_tpu_rl_with_the_port_module(topology, population, user, conda):
    raw = TOPOLOGIES[topology]
    args = ("machines.json", "params.json", "/src/repo", user, conda, "~/deploy")
    got = launch.plan(MachinesConfig.from_dict(raw), *args, population=population)
    want = jax_launch.plan(JaxMachines.from_dict(raw), *args, population=population)
    assert got == [_port_of(c) for c in want]
    assert all("-m tpu_rl_torch " in c[-1] for c in got if c[0] == "ssh")
    assert launch.RSYNC_EXCLUDES == jax_launch.RSYNC_EXCLUDES


def test_role_cmd_equals_tpu_rl():
    for kw in ({}, {"machine_idx": 1}, {"conda_env": "rl", "python": "python3"}):
        got = launch.role_cmd("worker", "m.json", "p.json", **kw)
        want = jax_launch.role_cmd("worker", "m.json", "p.json", **kw)
        assert got == want.replace("-m tpu_rl ", "-m tpu_rl_torch ")


def test_dry_run_prints_the_plan(capsys, tmp_path):
    machines = tmp_path / "machines.json"
    machines.write_text(json.dumps(TOPOLOGIES["one-host"]))
    assert launch.main(["--machines", str(machines), "--dry-run", "--population"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("$ rsync")
    assert "python -m tpu_rl_torch population" in lines[1]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


@pytest.mark.timeout(300)
def test_execute_two_role_deployment(tmp_path):
    """``python -m tpu_rl_torch.launch`` executes its plan through the
    stand-ins: the code push (excludes honoured), then the learner, manager
    and worker roles of the port inside the deployed copy, which stay up
    without a traceback until their sessions are killed."""
    workdir = tmp_path / "deploy"
    tmux_dir = tmp_path / "tmux"
    base = free_block(6)
    machines = {"learner": {"ip": "127.0.0.1", "port": base},
                "workers": [{"num_p": 1, "ip": "127.0.0.1", "manager_ip": "127.0.0.1",
                             "port": base + 5}]}
    params = {"env": "CartPole-v1", "algo": "PPO", "batch_size": 8, "seq_len": 5,
              "hidden_size": 16, "worker_num_envs": 1, "learner_device": "cpu"}
    staged = []
    for name, doc in (("machines", machines), ("params", params)):
        dst = REPO / f"_torch_launch_test_{name}.json"
        dst.write_text(json.dumps(doc))
        staged.append(dst)
    env = dict(os.environ, PATH=f"{FAKEBIN}:{os.environ['PATH']}", FAKE_TMUX_DIR=str(tmux_dir))
    env.pop("PYTHONSTARTUP", None)
    sessions = ["tpurl-learner", "tpurl-manager-0", "tpurl-worker-0"]
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_rl_torch.launch",
             "--machines", staged[0].name, "--params", staged[1].name,
             "--repo", str(REPO), "--workdir", str(workdir)],
            env=env, cwd=str(REPO), capture_output=True, text=True, timeout=240,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        printed = [ln for ln in proc.stdout.splitlines() if ln.startswith("$")]
        assert "rsync" in printed[0] and all("ssh" in ln for ln in printed[1:])
        assert all("-m tpu_rl_torch " in ln for ln in printed[1:])
        assert (workdir / "tpu_rl_torch" / "__main__.py").is_file()
        assert not (workdir / ".git").exists()
        pids = {}
        deadline = time.time() + 60
        while time.time() < deadline and len(pids) < len(sessions):
            for s in sessions:
                pf = tmux_dir / f"{s}.pid"
                if s not in pids and pf.exists():
                    pids[s] = int(pf.read_text())
            time.sleep(0.5)
        assert sorted(pids) == sorted(sessions), f"sessions up: {sorted(pids)}"
        time.sleep(8.0)  # the roles must survive their start, not crash-loop
        for s, pid in pids.items():
            log = (tmux_dir / f"{s}.log").read_text()
            assert _alive(pid), f"{s} (pid {pid}) died; log:\n{log[-2000:]}"
            assert "Traceback" not in log, f"{s} raised:\n{log[-2000:]}"
        for s in sessions:
            subprocess.run(["tmux", "kill-session", "-t", s], env=env, check=True)
        deadline = time.time() + 30
        while time.time() < deadline and any(_alive(p) for p in pids.values()):
            time.sleep(0.5)
        assert not any(_alive(p) for p in pids.values())
    finally:
        for dst in staged:
            dst.unlink(missing_ok=True)
        for s in sessions:
            pf = tmux_dir / f"{s}.pid"
            if pf.exists():
                try:
                    os.killpg(int(pf.read_text()), signal.SIGKILL)
                except (ProcessLookupError, ValueError):
                    pass
