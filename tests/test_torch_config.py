"""The port's ``Config.validate`` against ``tpu_rl``'s: for every field the
two classes share, each value of a fixed candidate list that ``tpu_rl``
refuses is refused by the port with the same exception type; the conv and
colocated refusals, ``action_repeat`` and ``zero_window_carry`` (fields,
with ``tpu_rl``'s defaults, asserts and warning)."""

import dataclasses
import warnings

import pytest

from tpu_rl.config import Config as JaxConfig
from tpu_rl_torch.config import FINGERPRINT_FIELDS, Config

SHARED = sorted(
    {f.name for f in dataclasses.fields(JaxConfig)}
    & {f.name for f in dataclasses.fields(Config)} - {"extra"}
)

# Values fed to every shared field: zero and negatives, fractions, numbers
# past a range, a huge port number, a string, None, a bool and (lo, hi)
# pairs in and out of order.
CANDIDATES = (0, -1, -0.5, 0.5, 1.5, 2, 65536, 1e9, "bogus", None, True, [1.0, 1.0], [2.0, 1.0])


def _refusal(cls, raw):
    """The exception type ``cls.from_dict(raw)`` raises, or None."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cls.from_dict(raw)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e)
    return None


def test_the_port_has_every_field_it_validates_against():
    """The fields this slice brings are shared, so the sweep below covers
    them; the port has no field that tpu_rl lacks."""
    assert {"action_repeat", "zero_window_carry", "height", "width", "need_conv"} <= set(SHARED)
    assert {f.name for f in dataclasses.fields(Config)} - {"extra"} == set(SHARED)


@pytest.mark.parametrize("key", SHARED)
def test_port_refuses_what_tpu_rl_refuses(key):
    """Each candidate value ``tpu_rl`` refuses for ``key``, the port refuses
    with the same exception type."""
    for value in CANDIDATES:
        want = _refusal(JaxConfig, {key: value})
        if want is None:
            continue
        got = _refusal(Config, {key: value})
        assert got is want, (key, value, want, got)
    # the default itself loads in both
    assert _refusal(JaxConfig, {key: getattr(JaxConfig(), key)}) is None
    assert _refusal(Config, {key: getattr(Config(), key)}) is None


@pytest.mark.parametrize("raw", [
    {"height": 0}, {"width": -1}, {"height": -3, "width": 84},
    {"env_mode": "colocated", "need_conv": True},
    {"env_mode": "colocated", "need_conv": True, "model": "transformer"},
    {"action_repeat": 0}, {"action_repeat": -2},
], ids=["height0", "width-1", "height-3", "colocated-conv", "colocated-conv-transformer",
        "action_repeat0", "action_repeat-2"])
def test_c6_refusals_match(raw):
    """ROADMAP C 6's inputs: tpu_rl raises AssertionError on each, and so
    does the port (it used to load them and ignore the keys)."""
    with pytest.raises(AssertionError):
        JaxConfig.from_dict(raw)
    with pytest.raises(AssertionError):
        Config.from_dict(raw)


def test_conv_settings_load_outside_colocated_mode():
    cfg = Config.from_dict({"need_conv": True, "height": 1, "width": 1, "is_gray": True})
    assert (cfg.need_conv, cfg.height, cfg.width, cfg.is_gray) == (True, 1, 1, True)
    assert cfg.extra == {}


@pytest.mark.parametrize("key,value", [("action_repeat", 8), ("zero_window_carry", True)])
def test_slice_keys_are_fields_with_tpu_rl_defaults(key, value):
    """Both keys load as fields (not ``extra``), with tpu_rl's defaults, and
    stay out of the resume fingerprint as in tpu_rl."""
    from tpu_rl.config import FINGERPRINT_FIELDS as JAX_FINGERPRINT

    assert getattr(Config(), key) == getattr(JaxConfig(), key)
    cfg = Config.from_dict({"algo": "IMPALA", key: value})
    assert getattr(cfg, key) == value and key not in cfg.extra
    assert key not in FINGERPRINT_FIELDS and key not in JAX_FINGERPRINT
    assert FINGERPRINT_FIELDS == tuple(JAX_FINGERPRINT)


@pytest.mark.parametrize("algo,warns", [
    ("PPO", True), ("PPO-Continuous", True), ("V-MPO", True),
    ("IMPALA", False), ("SAC", False), ("SAC-Continuous", False),
])
def test_zero_window_carry_warns_like_tpu_rl(algo, warns):
    """zero_window_carry=True warns for the GAE algorithms in both packages,
    with the same message, and for no other algorithm."""
    raw = {"algo": algo, "zero_window_carry": True}
    msgs = []
    for cls in (JaxConfig, Config):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cls.from_dict(raw)
        msgs.append([str(w.message) for w in caught if "zero_window_carry" in str(w.message)])
    assert msgs[0] == msgs[1]
    assert bool(msgs[1]) == warns
    if warns:
        assert msgs[1][0].startswith(f"zero_window_carry=True with {algo}: GAE-based")


# ROADMAP C 13: the keys of the planes the training-topology slice brings
# (tpu_rl/config.py:729-741, 847-865), which the port used to load into
# ``extra`` unchecked; tpu_rl's refusal of each, and the port's
C13 = [
    ({"sebulba_queue": 0}, AssertionError),
    ({"pop_seed": -1}, AssertionError),
    ({"pop_spec": "lr:log[1e-2,1e-4]"}, ValueError),
    ({"pop_spec": "env:choice[a,b]"}, ValueError),
    ({"autopilot_spec": "x"}, ValueError),
]


@pytest.mark.parametrize("raw,err", C13, ids=["sebulba_queue0", "pop_seed-1", "pop-lo-hi",
                                               "pop-choice-str", "autopilot-x"])
def test_c13_refusals_match(raw, err):
    with pytest.raises(err):
        JaxConfig.from_dict(raw)
    with pytest.raises(err):
        Config.from_dict(raw)


@pytest.mark.parametrize("key", ["autopilot_spec", "autopilot_poll_s", "autopilot_drain_s"])
def test_autopilot_keys_refused_where_tpu_rl_refuses(key):
    """The autopilot's keys stay in ``extra`` until its slice: every
    candidate ``tpu_rl`` refuses, the port refuses (its knobs with the same
    exception type; a spec string with a ValueError, as tpu_rl's parse
    error); a set spec is refused whatever it says, naming the slice that
    brings it; the defaults load."""
    from tpu_rl_torch.config import NotPortedError

    for value in CANDIDATES:
        want = _refusal(JaxConfig, {key: value})
        if want is None:
            continue
        got = _refusal(Config, {key: value})
        assert got is not None, (key, value, want)
        if key != "autopilot_spec" or isinstance(value, str):
            assert issubclass(got, want), (key, value, want, got)
    default = getattr(JaxConfig(), key)
    assert Config.from_dict({key: default}).extra == {key: default}
    if key == "autopilot_spec":
        spec = "scale_out:replicas?burn:inference-rtt>0.5@sustain=3@max=4"
        JaxConfig.from_dict({key: spec})
        with pytest.raises(NotPortedError, match="serving and operations slice"):
            Config.from_dict({key: spec})


def test_slice_fields_round_trip_through_to_json(tmp_path):
    """The population controller rewrites a member's config.json: the
    port's Config writes what it loads, the ``extra`` keys included."""
    raw = {"env_mode": "colocated", "sebulba_split": 1, "sebulba_queue": 3,
           "pop_spec": "lr:log[1e-4,1e-3] k=2", "pop_seed": 7, "chaos_seed": 5,
           "value_target_clip": [0.0, 1.0]}
    cfg = Config.from_dict(raw)
    cfg.to_json(tmp_path / "c.json")
    back = Config.from_json(tmp_path / "c.json")
    assert back == cfg and back.extra == {"chaos_seed": 5}
    assert JaxConfig.from_json(tmp_path / "c.json").pop_seed == 7
