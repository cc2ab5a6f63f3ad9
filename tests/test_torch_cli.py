"""The port's CLI against ``tpu_rl``'s: every option string of
``tpu_rl.__main__.build_parser()`` is in the port's parser, with no
exception left; the roles are the same; ``--mesh-data`` follows
``tpu_rl``'s rule (0 is no override); the chaos and autopilot flags land
in the same Config fields in both packages."""

import pytest

from tpu_rl.__main__ import build_parser as jax_parser
from tpu_rl.__main__ import load_config as jax_load
from tpu_rl_torch.__main__ import build_parser, load_config


def _options(parser) -> dict:
    return {o: a for a in parser._actions for o in a.option_strings}


def test_every_tpu_rl_flag_is_in_the_port():
    ours = _options(build_parser())
    theirs = _options(jax_parser())
    missing = sorted(set(theirs) - set(ours))
    assert missing == []
    # and each takes a value, or not, as tpu_rl's does
    for opt, action in theirs.items():
        assert (ours[opt].nargs, type(ours[opt]).__name__) == \
            (action.nargs, type(action).__name__), opt


def test_roles_match():
    def roles(p):
        return next(a.choices for a in p._actions if a.dest == "role")

    assert roles(build_parser()) == roles(jax_parser())
    assert "autopilot" in roles(build_parser())


@pytest.mark.parametrize("argv,want", [
    (["learner", "--mesh-data", "2"], 2),
    (["learner", "--mesh-data", "0"], 1),
    (["learner"], 1),
])
def test_mesh_data_flag(argv, want):
    """C 14: ``--mesh-data N`` sets ``mesh_data`` in both packages; 0 leaves
    the default, as tpu_rl's truthiness rule does."""
    got = load_config(build_parser().parse_args(argv))[0].mesh_data
    ref = jax_load(jax_parser().parse_args(argv))[0].mesh_data
    assert got == ref == want


def test_chaos_and_autopilot_flags_land_in_the_same_fields():
    argv = ["autopilot", "--chaos-spec", "kill:inference-1@t+5s,stall:inference@40ms",
            "--chaos-seed", "11", "--autopilot-spec",
            "scale_out:replicas?burn:inference-rtt>0.5@max=3", "--autopilot-poll", "0.25",
            "--autopilot-manage-all"]
    ours, theirs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert ours.autopilot_manage_all is theirs.autopilot_manage_all is True
    cfg, jcfg = load_config(ours)[0], jax_load(theirs)[0]
    for key in ("chaos_spec", "chaos_seed", "autopilot_spec", "autopilot_poll_s",
                "autopilot_drain_s"):
        assert getattr(cfg, key) == getattr(jcfg, key), key
    assert (cfg.chaos_seed, cfg.autopilot_poll_s) == (11, 0.25)


def test_bad_specs_are_refused_at_load():
    for argv in (["local", "--chaos-spec", "corrupt:rollout"],
                 ["local", "--autopilot-spec", "scale_out:gpus?burn:x>1"]):
        with pytest.raises(ValueError):
            jax_load(jax_parser().parse_args(argv))
        with pytest.raises(ValueError):
            load_config(build_parser().parse_args(argv))
