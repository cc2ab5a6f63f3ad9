"""``chip_smoke.py`` stops every process it starts: having made itself the
subreaper of its descendants, its end-of-run sweep finds an orphan in a
session of its own, a stopped child and a child that ignores SIGTERM, stops
all three, reaps them, and leaves multiprocessing's resource tracker alone;
a SIGTERM from outside runs the same sweep before the smoke exits. The
checks run in subprocesses, so that the subreaper attribute and the signal
handlers stay off the test process."""

import json
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import json, multiprocessing as mp, os, signal, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs

SLEEP = [sys.executable, "-c", "import time; time.sleep(120)"]
DEAF = [sys.executable, "-c",
        "import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); "
        "print(1, flush=True); time.sleep(120)"]


def orphan_maker():
    subprocess.Popen(SLEEP, start_new_session=True)


if __name__ == "__main__":
    cs.adopt_orphans()
    ctx = mp.get_context("spawn")
    lock = ctx.Lock()  # starts the resource tracker
    tracker = mp.resource_tracker._resource_tracker._pid
    maker = ctx.Process(target=orphan_maker)
    maker.start()
    maker.join()
    stopped = subprocess.Popen(SLEEP)
    os.kill(stopped.pid, signal.SIGSTOP)
    deaf = subprocess.Popen(DEAF, stdout=subprocess.PIPE, text=True)
    deaf.stdout.readline()  # its SIGTERM handler is set
    left = cs.stop_leftovers(grace_s=1.0)
    print(json.dumps(dict(
        left=left, stopped=stopped.pid, deaf=deaf.pid,
        tracker_running=cs.running(tracker),
        after=[p for p in cs.children_of(os.getpid()) if p != tracker],
        again=cs.stop_leftovers(grace_s=1.0))))
"""


def test_stop_leftovers_stops_orphans_stopped_and_deaf_children(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(_PROBE)
    out = subprocess.run([sys.executable, str(probe), str(REPO)], capture_output=True,
                         text=True, timeout=60, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    pids = {d["pid"]: d for d in doc["left"]}
    assert len(pids) == 3, doc
    assert {doc["stopped"], doc["deaf"]} <= set(pids)
    # the third is the orphan, re-parented here when its parent ended
    (orphan,) = set(pids) - {doc["stopped"], doc["deaf"]}
    assert "time.sleep(120)" in pids[orphan]["cmd"]
    assert pids[doc["deaf"]].get("killed") is True
    assert not pids[doc["stopped"]].get("killed")
    assert doc["tracker_running"] is True
    assert doc["after"] == [] and doc["again"] == []


_STOPPED = """
import os, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs

if __name__ == "__main__":
    cs.adopt_orphans()
    kid = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    orphan = subprocess.Popen([sys.executable, "-c",
                               "import subprocess, sys; print(subprocess.Popen([sys.executable, "
                               "'-c', 'import time; time.sleep(120)']).pid)"],
                              stdout=subprocess.PIPE, text=True)
    grandchild = int(orphan.stdout.readline())
    orphan.wait()
    print(kid.pid, grandchild, flush=True)
    time.sleep(120)
"""


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state not in ("Z", "X")


def test_sigterm_stops_the_runs_processes(tmp_path):
    probe = tmp_path / "stopped.py"
    probe.write_text(_STOPPED)
    smoke = subprocess.Popen([sys.executable, str(probe), str(REPO)], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=tmp_path)
    try:
        kid, grandchild = map(int, smoke.stdout.readline().split())
        assert _alive(kid) and _alive(grandchild)
        smoke.send_signal(signal.SIGTERM)
        _, err = smoke.communicate(timeout=30)
    finally:
        smoke.kill()
    assert smoke.returncode == 128 + signal.SIGTERM, err[-2000:]
    assert "stopped 2 processes" in err, err[-2000:]
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and (_alive(kid) or _alive(grandchild)):
        time.sleep(0.1)
    assert not _alive(kid) and not _alive(grandchild)


_CHAOS = """
import json, os, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from tpu_rl_torch.chaos import ProcessChaos
from tpu_rl_torch.runtime.runner import Supervisor

SLEEP = [sys.executable, "-c", "import time; time.sleep(120)"]


def parent(stop_event, heartbeat):
    # a role with a child of its own: SIGKILLed by chaos, it orphans it
    subprocess.Popen(SLEEP)
    while not stop_event.is_set():
        heartbeat.value = time.time()
        time.sleep(0.05)


def up(child):
    # the child loops (its sleeper started) once its heartbeat moves on
    t = child.heartbeat.value
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and child.heartbeat.value <= t + 0.1:
        time.sleep(0.05)


if __name__ == "__main__":
    cs.adopt_orphans()
    sup = Supervisor(poll_s=0.05, heartbeat_timeout=60.0, startup_grace=60.0,
                     log_root=sys.argv[2],
                     chaos=ProcessChaos.from_spec("kill:parent-0@t+0.2s"))
    first_child = sup.spawn("parent-0", parent)
    first = first_child.proc.pid
    up(first_child)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and sup.children[0].restarts == 0:
        sup.poll_chaos()
        sup.check()
        time.sleep(0.05)
    up(sup.children[0])
    # a child spawned once the phase was under way (an autopilot scale-out)
    late_child = sup.spawn("late-1", parent)
    late = late_child.proc.pid
    up(late_child)
    orphans = [p for p in cs.children_of(os.getpid()) if "time.sleep(120)" in
               open(f"/proc/{p}/cmdline", "rb").read().decode(errors="replace")]
    respawned = sup.children[0].proc.pid
    left = cs.stop_leftovers(grace_s=1.0)
    tracker = __import__("multiprocessing").resource_tracker._resource_tracker._pid
    print(json.dumps(dict(
        left=[d["pid"] for d in left], first=first, respawned=respawned, late=late,
        orphans=orphans, kills=sup.chaos.n_kills, restarts=sup.children[0].restarts,
        first_state=cs.proc_state(first),
        after=[p for p in cs.children_of(os.getpid()) if p != tracker],
        again=cs.stop_leftovers(grace_s=1.0))))
"""


def test_stop_leftovers_reaps_chaos_killed_and_late_children(tmp_path):
    """A supervised child SIGKILLed by the chaos plane (its own child
    orphaned to the run), its respawn, and a child spawned after the phase
    began: the sweep stops the respawn, the late child, the orphan and
    their children, and no process of the run, zombie or not, is left."""
    probe = tmp_path / "chaos_probe.py"
    probe.write_text(_CHAOS)
    out = subprocess.run([sys.executable, str(probe), str(REPO), str(tmp_path / "logs")],
                         capture_output=True, text=True, timeout=90, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["kills"] == 1 and doc["restarts"] == 1
    assert doc["respawned"] != doc["first"]
    # the killed child is gone and reaped; its orphan came to the run
    assert doc["first_state"] is None
    assert len(doc["orphans"]) == 1
    left = set(doc["left"])
    assert {doc["respawned"], doc["late"], *doc["orphans"]} <= left
    # the respawn's and the late child's own sleepers: 2 more
    assert len(left) == 5, doc
    assert doc["after"] == [] and doc["again"] == []


def test_free_blocks_never_overlap_across_threads():
    """Port blocks handed out to phases on two threads never overlap, and
    no single free port falls inside one: a replica spawned minutes after
    its block was chosen still finds its port free of the smoke's own
    use."""
    import threading

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    got: list[tuple[int, int]] = []

    def take() -> None:
        for n in (14, 12, 8):
            base = cs.free_block(n)
            got.append((base, base + n))

    threads = [threading.Thread(target=take) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 12
    for i, (lo, hi) in enumerate(got):
        assert all(hi <= lo2 or hi2 <= lo for lo2, hi2 in got[i + 1:]), got
    ports = [cs.free_port() for _ in range(50)]
    assert not [p for p in ports if any(lo <= p < hi for lo, hi in got)]
