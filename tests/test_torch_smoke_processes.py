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
