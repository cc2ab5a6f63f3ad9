"""The plain reference against the port's train step on the CPU at small
sizes, for both configurations, and its control: the reference one
precision below (TF32) fails the limits the configurations state, also
where the first update's kinks give the reference several ways."""

import pytest
import torch

from portbench import check, spec
from portbench.program import Program
from portbench.reference.matmul import to_tf32
from portbench.run import first_updates, reference
from portbench.traffic import make_batch
from portbench.weights import make_weights

CELLS = ["tf-longctx-f32.long-episodes", "lstm-wide-impala.cartpole-episodes"]


def readings(root, cell_name, seed, control=False, with_kinks=False):
    bench = spec.load_benchmark(root)
    cell = spec.find(bench["workloads"], cell_name, "workload")
    conf = spec.load_config(bench, cell["config"], root)
    mix = spec.load_traffic(cell["traffic"], root)
    cfg = conf["config"]
    weights = make_weights(cfg, conf["architecture"], seed, "cpu")
    ref = reference(conf, mix, seed, weights, "cpu", "float32")
    if with_kinks:
        assert ref["kinks"] >= 2 and len(ref["variants"]) == 2 ** ref["kinks"]
    if control:
        ctl = reference(conf, mix, seed, weights, "cpu", "tf32")["variants"][0]
        got = check.readings(ctl["loss"], ctl["grad_norms"], ctl["change_norms"], ref)
    else:
        program = Program(cfg, weights, "cpu")
        batches = [program.batch(make_batch(cfg, mix, seed, i, "cpu")) for i in range(3)]
        losses, grads, changes = first_updates(program, batches, weights,
                                               conf["check"]["updates"])
        got = check.readings(losses, grads, changes, ref)
    return check.judge(got, conf["check"]["limits"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 17])
def test_the_port_agrees_with_the_reference(tiny, cell, seed):
    checks = readings(tiny, cell, seed)
    assert check.passed(checks), checks
    # well inside the limits: the port and the reference compute the same f32 step
    assert all(c["value"] < c["limit"] / 3 for c in checks.values()), checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(tiny, cell):
    checks = readings(tiny, cell, 3, control=True)
    assert not check.passed(checks), checks


@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_the_ways_of_the_kinks_pass_the_program_and_fail_the_control(tiny, monkeypatch, control):
    # A band around the clip edges wide enough that a tiny batch has kinks.
    from portbench.reference import losses

    monkeypatch.setattr(losses, "KINK", 0.006)
    checks = readings(tiny, CELLS[0], 12, control=control, with_kinks=True)  # 3 kinks
    assert check.passed(checks) is not control, checks


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 1.0 + 2**-12, -3.0])
    assert to_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]


def test_a_ratio_at_a_clip_edge_is_a_kink():
    from portbench.reference.losses import ppo

    cfg = dict(gamma=0.99, lmbda=0.95, eps_clip=0.1, policy_loss_coef=1.0, value_loss_coef=0.5,
               entropy_coef=0.0)
    logp_all = torch.log_softmax(torch.zeros(1, 4, 2), -1)  # log(1/2) everywhere
    batch = {"act": torch.zeros(1, 4, dtype=torch.long), "is_fir": torch.zeros(1, 4),
             "rew": torch.ones(1, 4)}
    value = torch.zeros(1, 4)  # every advantage > 0
    edge = torch.log(torch.tensor(0.5)) - torch.log(torch.tensor(1.1))
    for behaviour, kinks in ((edge, 1), (edge - 0.01, 0)):
        log_prob = torch.full((1, 4), -2.0)
        log_prob[0, 1] = behaviour  # that step's ratio: 0.5 / exp(behaviour)
        *_, found = ppo(logp_all, value, dict(batch, log_prob=log_prob), cfg)
        assert found.numel() == kinks


def test_a_kink_falling_the_other_way_is_one_of_the_references_ways():
    from portbench.reference.step import train

    # one leaf w, the policy's logits w * x; one step's ratio sits at the clip edge 1.1
    cfg = dict(algo="PPO", model="transformer", gamma=0.99, lmbda=0.95, eps_clip=0.1,
               policy_loss_coef=1.0, value_loss_coef=0.5, entropy_coef=0.0,
               max_grad_norm=40.0, lr=1e-4)
    from portbench.reference import step

    def block_loss(p, rows, cfg_, arch, precision):
        from portbench.reference.losses import ppo

        logp_all = torch.log_softmax(p["w"] * rows["obs"], -1)
        return ppo(logp_all, torch.zeros(1, 4), rows, cfg_)

    batch = {"obs": torch.tensor([[[1.0, 0.0]] * 4]), "act": torch.zeros(1, 4, dtype=torch.long),
             "is_fir": torch.zeros(1, 4), "rew": torch.ones(1, 4)}
    w = torch.tensor([[0.3, 0.0]])
    logp = torch.log_softmax(w * batch["obs"], -1)[0, 0, 0]
    batch["log_prob"] = torch.full((1, 4), float(logp))  # ratio 1: inside the clip
    batch["log_prob"][0, 1] = logp - torch.log(torch.tensor(1.1))  # that step: ratio 1.1
    old = step._block_loss
    step._block_loss = block_loss
    try:
        ref = train({"w": w}, [batch], cfg, {}, "float32", 1)
    finally:
        step._block_loss = old
    assert ref["kinks"] == 1
    a, b = (v["grad_norms"]["w"] for v in ref["variants"])
    assert a != b  # the term is in one way's gradient and not in the other's
    for way in ref["variants"]:
        got = check.readings(way["loss"], way["grad_norms"], way["change_norms"], ref)
        assert got == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


def test_a_leaf_gap_is_relative_to_the_leaf_or_the_median_leaf():
    got, want = {"a": 1.0, "b": 2.0 + 3e-4, "c": 1e-6}, {"a": 1.0, "b": 2.0, "c": 0.0}
    assert check.leaf_gap(got, want, want) == pytest.approx(1.5e-4)
    assert check.leaf_gap(got, want, ["a", "c"]) == pytest.approx(2e-6)
