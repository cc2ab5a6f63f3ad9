"""The port's copies of ``tpu_rl.obs.report`` and ``tpu_rl.obs.compare``
against the originals: run histories written by the port's
``TimeSeriesStore`` (an injected clock, several chunks, a regressed, a
missing and a new channel, audit events beside them) are read by both
packages; ``build_report`` (but for its ``generated_at`` stamp),
``render_markdown``, ``render_html``, ``compare_runs`` and both ``main``s
(exit codes, printed lines, written files) are equal."""

import json
import os

import pytest

from tpu_rl.obs import compare as jax_compare
from tpu_rl.obs import report as jax_report
from tpu_rl.obs.history import HistoryReader as JaxReader
from tpu_rl_torch.obs import TelemetryAggregator, TimeSeriesStore, append_jsonl, append_resume
from tpu_rl_torch.obs import compare, report
from tpu_rl_torch.obs.history import HistoryReader


class FakeClock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _write_run(root, shift=1.0, drop=(), extra=()):
    """A run dir: 40 history rows at 5 s steps over 20 s chunks; channel
    values scaled by ``shift``; ``drop`` channels left out, ``extra``
    channels added; a resume and a chaos event."""
    hist = os.path.join(root, "history")
    clock = FakeClock(1000.0)
    store = TimeSeriesStore(hist, chunk_s=20.0, retention_s=3600.0, clock=clock)
    agg = TelemetryAggregator()
    for i in range(40):
        clock.t = 1000.0 + 5.0 * i
        reg = agg.registry
        reg.gauge("colocated-updates-per-s").set(shift * (50.0 + (i % 7)))
        reg.gauge("colocated-env-steps-per-s").set(shift * (6400.0 + 13 * (i % 5)))
        reg.gauge("colocated-mfu").set(0.01 + 0.0001 * (i % 3))
        reg.counter("colocated-updates").set_total(10 * i)
        samples = {"learner/learner-diag-ess": 0.9 - 0.001 * (i % 4),
                   "learner/policy-staleness-updates-p99": 2.0 + (i % 2)}
        for ch in drop:
            samples.pop(ch, None)
        for ch in extra:
            samples[ch] = float(i)
        store.record(agg, extra=samples)
    store.close()
    append_resume(root, idx=120, epoch=1)
    append_jsonl(root, "chaos.jsonl", {"t": 1050.0, "action": "inject", "target": "rollout"})
    with open(os.path.join(root, "chaos.jsonl"), "a") as f:
        f.write('{"t": 10')  # a torn tail line: skipped by both
    return root


@pytest.fixture()
def runs(tmp_path):
    base = _write_run(str(tmp_path / "base"))
    cand = _write_run(str(tmp_path / "cand"), shift=0.5,
                      drop=("learner/learner-diag-ess",), extra=("learner/new-channel",))
    return base, cand


@pytest.mark.parametrize("patterns", [None, ("*",), ("storage/colocated-*", "*-mfu")],
                         ids=["default", "all", "picked"])
def test_build_and_render_report_match(runs, patterns):
    base, _cand = runs
    kw = {} if patterns is None else {"patterns": patterns}
    got, want = report.build_report(base, **kw), jax_report.build_report(base, **kw)
    assert got.pop("generated_at") > 0 and want.pop("generated_at") > 0
    assert got == want
    assert got["channels"] and got["events"]
    assert report.render_markdown(got) == jax_report.render_markdown(want)
    assert report.render_html(got, HistoryReader(got["history_dir"])) == \
        jax_report.render_html(want, JaxReader(want["history_dir"]))


@pytest.mark.parametrize("pair", ["self", "regressed", "reversed"])
def test_compare_runs_match(runs, pair):
    base, cand = runs
    a, b = {"self": (base, base), "regressed": (base, cand), "reversed": (cand, base)}[pair]
    a, b = os.path.join(a, "history"), os.path.join(b, "history")
    got, want = compare.compare_runs(a, b), jax_compare.compare_runs(a, b)
    assert got == want
    assert got["ok"] is (pair == "self")
    if pair == "regressed":
        verdicts = {r["channel"]: r["verdict"] for r in got["rows"]}
        assert verdicts["learner/learner-diag-ess"] == "no-data"
        assert verdicts["learner/new-channel"] == "new"
        assert verdicts["storage/colocated-updates-per-s"] == "regressed"


@pytest.mark.parametrize("tool", ["report", "compare-self", "compare-regressed", "missing"])
def test_mains_match(runs, tool, tmp_path, capsys):
    """Both packages' command lines: the same exit code, the same printed
    lines (paths aside) and, for the report, the same files."""
    base, cand = runs
    outs = []
    for mod_report, mod_compare, tag in ((report, compare, "port"),
                                         (jax_report, jax_compare, "tpu_rl")):
        out_dir = str(tmp_path / f"out-{tag}")
        if tool == "report":
            rc = mod_report.main([base, "--out", out_dir])
        elif tool == "missing":
            rc = mod_report.main([str(tmp_path / "nowhere")])
        else:
            other = base if tool == "compare-self" else cand
            rc = mod_compare.main([base, other, "--json", os.path.join(str(tmp_path), f"{tag}.json")])
        text = capsys.readouterr()
        outs.append((rc, (text.out + text.err).replace(out_dir, "OUT")))
        if tool == "report":
            files = sorted(os.listdir(out_dir))
            docs = {}
            for name in files:
                content = open(os.path.join(out_dir, name)).read()
                docs[name] = json.loads(content) if name.endswith(".json") else content
            docs["report.json"].pop("generated_at")
            outs[-1] += (docs,)
    assert outs[0] == outs[1]
    want_rc = {"report": 0, "compare-self": 0, "compare-regressed": 1, "missing": 2}[tool]
    assert outs[0][0] == want_rc
    if tool.startswith("compare"):
        got = json.load(open(os.path.join(str(tmp_path), "port.json")))
        assert got == json.load(open(os.path.join(str(tmp_path), "tpu_rl.json")))
