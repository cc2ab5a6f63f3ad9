"""The port's population plane (``tpu_rl_torch.population``) against
``tpu_rl``'s: the grammar's error matrix, ``fold_in``, ``member_seed`` (and
its pins), ``sample_member``, ``mutate``, ``truncation_select``,
``flatten_telemetry`` and ``population_doc`` equal on the same inputs; the
member port blocks and each member's nested topology equal to ``tpu_rl``'s
plan; the CLI's population flags; and a K=2 colocated population on the
CPU that reaches ``done`` with at least one exploit, the exploited member
resuming the copied committed checkpoint at a bumped run epoch."""

import json
import os

import pytest

from tpu_rl import population as jax_pop
from tpu_rl.config import Config as JaxConfig
from tpu_rl.config import MachinesConfig as JaxMachines
from tpu_rl.population import controller as jax_ctrl
from tpu_rl.runtime import portplan as jax_portplan
from tpu_rl_torch import population as pop
from tpu_rl_torch.config import Config, MachinesConfig
from tpu_rl_torch.population import controller as ctrl
from tpu_rl_torch.runtime import portplan

SPEC = "lr:log[1e-4,1e-2] entropy_coef:lin[0,0.05] perturb=1.2,0.8 interval=200u k=4"

ERRORS = [
    ("", "empty pop spec"),
    ("perturb=1.2,0.8", "no sampled dimension"),
    ("lr:log[1e-4]", "exactly"),
    ("lr:log[0,1e-2]", "lo > 0"),
    ("lr:lin[2,1]", "lo < hi"),
    ("lr:geo[1,2]", "unknown kind"),
    ("lr:choice[5]", ">= 2 values"),
    ("lr:log[1e-4,1e-2] lr:lin[0,1]", "sampled twice"),
    ("lr:log[1e-4,1e-2] perturb=0,1", "> 0"),
    ("lr:log[1e-4,1e-2] interval=10x", "interval needs a unit"),
    ("lr:log[1e-4,1e-2] quantile=0.9", "quantile"),
    ("lr:log[1e-4,1e-2] k=1", "k >= 2"),
    ("lr:log[1e-4,1e-2] bogus=3", "unknown knob"),
    ("env:choice[a,b]", "must be a number"),
    ("lr:log[1e-4,1e-2] k=4 quantile=0.5 lr", "expected 'key=value'"),
]


def _error(mod, text):
    try:
        mod.PopSpec.parse(text)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("text,msg", ERRORS, ids=[e[1] or "empty" for e in ERRORS])
def test_grammar_error_matrix_matches(text, msg):
    """Each malformed spec is refused by both packages with the same
    message."""
    want = _error(jax_pop, text)
    assert want is not None and msg in want
    assert _error(pop, text) == want


@pytest.mark.parametrize("text", [
    SPEC,
    "lr:log[1e-4,1e-2]; entropy_coef:lin[0,0.05] perturb=1.3,0.7 interval=30s quantile=0.5 "
    "k=8 fitness=my-gauge",
    "time_horizon:choice[100,200,300] k=3",
    "lr:log[1e-4,1e-3] interval=50u k=2 quantile=0.5",
])
def test_parse_sample_and_mutate_match(text):
    """The parsed spec, every member's draw and every mutation are equal
    across packages (int dims cast the same)."""
    got, want = pop.PopSpec.parse(text), jax_pop.PopSpec.parse(text)
    assert got.k == want.k and got.perturb == want.perturb
    assert (got.interval, got.interval_unit, got.quantile, got.fitness) == (
        want.interval, want.interval_unit, want.quantile, want.fitness)
    assert [(d.field, d.kind, d.lo, d.hi, d.choices) for d in got.dims] == [
        (d.field, d.kind, d.lo, d.hi, d.choices) for d in want.dims]
    got.check_searchable()
    for seed in (0, 3, 11):
        for idx in range(got.k):
            values = pop.sample_member(got, seed, idx)
            assert values == jax_pop.sample_member(want, seed, idx)
            for gen in range(3):
                assert pop.mutate(got, values, seed, idx, gen) == jax_pop.mutate(
                    want, values, seed, idx, gen)


def test_seed_derivation_matches_and_is_pinned():
    assert [pop.member_seed(0, k) for k in range(4)] == [
        1627376989, 1800489502, 1998321373, 558460563]
    for seed in (0, 1, 7, 2**31 - 1):
        for k in range(6):
            assert pop.member_seed(seed, k) == jax_pop.member_seed(seed, k)
            assert pop.fold_in(seed, k, 0x5E1) == jax_pop.fold_in(seed, k, 0x5E1)


@pytest.mark.parametrize("fitness,q", [
    ({0: 1.0, 1: 5.0, 2: 3.0, 3: 0.5}, 0.25),
    ({0: 1.0, 1: 5.0, 2: 3.0, 3: 0.5}, 0.5),
    ({0: 1.0}, 0.5), ({}, 0.5), ({0: 1.0, 1: 2.0, 2: 3.0}, 0.5),
    ({0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}, 0.25), ({0: -1e30, 1: 2.0}, 0.5),
])
def test_truncation_select_matches(fitness, q):
    assert pop.truncation_select(fitness, q) == jax_pop.truncation_select(fitness, q)


def test_unsearchable_fields_refused_in_both():
    for text in ("env:log[1,2]", "hidden_size:lin[1,5]", "seq_len:choice[5,10]"):
        for mod in (pop, jax_pop):
            with pytest.raises(ValueError, match="searchable"):
                mod.PopSpec.parse(text).check_searchable()
    assert {"lr", "entropy_coef", "time_horizon"} <= set(pop.spec.searchable_fields())
    assert set(pop.spec.searchable_fields()) <= set(jax_pop.spec.searchable_fields())


def _members(mod):
    a = mod.MemberState(idx=0, dir="/d/0", seed=1, values={"lr": 1e-3})
    b = mod.MemberState(idx=1, dir="/d/1", seed=2, values={"lr": 2e-3})
    c = mod.MemberState(idx=2, dir="/d/2", seed=3, values={})
    a.fitness, a.best_fitness = 10.0, 50.0
    b.fitness, b.best_fitness = 90.0, 90.0
    b.lineage.append({"ev": "exploit", "winner": 0})
    return [a, b, c]


def test_documents_match():
    doc = {"sources": [
        {"counters": [["colocated-updates", {}, 100.0]],
         "gauges": [["colocated-mean-episode-return", {}, 12.0]]},
        {"counters": [], "gauges": [["colocated-mean-episode-return", {"x": "1"}, 30.5]]},
    ]}
    assert ctrl.flatten_telemetry(doc) == jax_ctrl.flatten_telemetry(doc)
    assert ctrl.flatten_telemetry({}) == jax_ctrl.flatten_telemetry({}) == {}
    counts = {"evals": 3, "exploits": 1}
    for ok in (True, False):
        got = ctrl.population_doc(_members(ctrl), 3, counts, ok)
        assert got == jax_ctrl.population_doc(_members(jax_ctrl), 3, counts, ok)
        json.dumps(got)


@pytest.mark.parametrize("telemetry_port", [0, 42000])
@pytest.mark.parametrize("k", [2, 4])
def test_member_port_blocks_match_tpu_rl(tmp_path, telemetry_port, k):
    """The member telemetry ports and the distributed members' port blocks
    equal tpu_rl's plan, and so does each member's nested topology."""
    raw = {"learner": {"ip": "127.0.0.1", "port": 40000},
           "workers": [{"num_p": 2, "ip": "127.0.0.1", "manager_ip": "127.0.0.1",
                        "port": 40010}]}
    m, jm = MachinesConfig.from_dict(raw), JaxMachines.from_dict(raw)
    kw = dict(env="CartPole-v1", telemetry_port=telemetry_port, result_dir=str(tmp_path),
              pop_spec=f"lr:log[1e-4,1e-3] k={k} fitness=learner-mean-reward")
    cfg, jcfg = Config.from_dict(kw), JaxConfig.from_dict(kw)
    assert portplan.plan_member_telemetry_ports(m, cfg, k) == \
        jax_portplan.plan_member_telemetry_ports(jm, jcfg, k)
    assert portplan.plan_member_port_blocks(m, cfg, k) == \
        jax_portplan.plan_member_port_blocks(jm, jcfg, k)
    controllers = []
    for cls, c, mm in ((jax_ctrl.PopulationController, jcfg, jm),
                       (ctrl.PopulationController, cfg, m)):
        controllers.append(cls(c, machines=mm, log=False))
        if controllers[-1]._http is not None:  # the controller's own /metrics
            controllers[-1]._http.close()
    want, got = controllers
    for i in range(k):
        assert got._member_machines(i) == want._member_machines(i)
        assert got.members[i].values == want.members[i].values
        assert got.members[i].seed == want.members[i].seed


def test_cli_takes_the_population_flags(tmp_path):
    from tpu_rl_torch.__main__ import build_parser, load_config

    args = build_parser().parse_args([
        "population", "--env-mode", "colocated", "--pop-spec", "lr:log[1e-4,1e-3] k=2",
        "--pop-seed", "3", "--sebulba-queue", "3", "--result-dir", str(tmp_path)])
    cfg, _m = load_config(args)
    assert (cfg.pop_spec, cfg.pop_seed, cfg.sebulba_queue) == ("lr:log[1e-4,1e-3] k=2", 3, 3)
    args = build_parser().parse_args(["population", "--pop-spec", "lr:log[1e-2,1e-4]"])
    with pytest.raises(ValueError, match="need lo < hi"):
        load_config(args)


@pytest.mark.timeout(300)
def test_colocated_population_exploits_and_finishes(tmp_path):
    """K=2 colocated PPO members on the CPU, member 0 poisoned (lr 0.05):
    the population reaches ``done`` ok with at least one exploit; the
    exploited member resumes the copied committed checkpoint at a bumped
    run epoch (its learner_resume.jsonl); every member's telemetry is
    scraped; population.json ranks the members."""
    cfg = Config.from_dict(dict(
        env="CartPole-v1", env_mode="colocated", algo="PPO", colocated_envs=16, hidden_size=16,
        learner_device="cpu", result_dir=str(tmp_path), model_save_interval=10,
        loss_log_interval=5, telemetry_interval_s=0.1, supervise_poll_s=0.2, ckpt_async=False,
        pop_spec="lr:log[1e-4,1e-3] interval=60u k=2 quantile=0.5", pop_seed=3,
        heartbeat_timeout_s=60.0))
    events = []
    c = ctrl.PopulationController(cfg, max_updates=400, log=False,
                                  initial_values={0: {"lr": 0.05}}, on_event=events.append)
    doc = c.run()
    kinds = [e["ev"] for e in events]
    assert doc["ok"] and kinds[-1] == "done", kinds
    assert doc["counts"]["exploits"] >= 1, [e for e in events if e["ev"].startswith("exploit")]
    # a loser exploited again before its respawn resumed never writes that
    # resume: the last exploit of a member is the one its process resumes
    exploit = [e for e in events if e["ev"] == "exploit"][-1]
    loser = exploit["loser"]
    resumes = [json.loads(x) for x in
               open(os.path.join(tmp_path, f"member-{loser}", "learner_resume.jsonl"))]
    assert any(r["idx"] == exploit["dst_idx"] and r["epoch"] == exploit["epoch"] + 1
               for r in resumes), (resumes, exploit)
    saved = json.load(open(os.path.join(tmp_path, "population.json")))
    assert [r["member"] for r in saved["leaderboard"]] == [
        r["member"] for r in doc["leaderboard"]]
    assert all(m.fitness is not None and m.progress > 0 for m in c.members)
    lines = [json.loads(x) for x in open(os.path.join(tmp_path, "population.jsonl"))]
    assert {"spawn", "eval", "exploit", "done"} <= {x["ev"] for x in lines}
