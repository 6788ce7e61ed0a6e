"""The traffic generator: the stream is a function of the seed alone."""

import json
import os

import pytest
import torch

from conftest import BENCH
from harness.traffic import ACTIONS, STREAM_STEPS, check_mix, make_stream

BIG_SEED = 2**31 + 987654321


def _mix(name="explore_fs1", **kw):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        mix = json.load(f)
    mix.update(kw)
    return mix


def test_same_seed_same_stream_other_seed_the_pool_dealt_anew():
    mix = _mix()
    a = make_stream(mix, 64, BIG_SEED, "cpu")
    b = make_stream(mix, 64, BIG_SEED, "cpu")
    c = make_stream(mix, 64, BIG_SEED + 1, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.spawn_yaw, c.spawn_yaw)
    # The same envs (yaw and actions together), in other slots.
    order_a, order_c = torch.argsort(a.spawn_yaw), torch.argsort(c.spawn_yaw)
    assert torch.equal(a.spawn_yaw[order_a], c.spawn_yaw[order_c])
    assert torch.equal(a.movement[:, order_a], c.movement[:, order_c])
    assert torch.equal(a.look[:, order_a], c.look[:, order_c])
    assert torch.equal(a.use[:, order_a], c.use[:, order_c])
    # Only the seed and the mix's numbers: the same mix under another file
    # name deals the same stream.
    d = make_stream(dict(mix, why="another mix of the same numbers"), 64, BIG_SEED, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, d))


def test_groups_keep_their_envs():
    mix = _mix()
    a = make_stream(mix, 64, 1, "cpu", groups=4)
    c = make_stream(mix, 64, 2, "cpu", groups=4)
    for g in range(4):
        ya, yc = a.spawn_yaw[16 * g:16 * (g + 1)], c.spawn_yaw[16 * g:16 * (g + 1)]
        assert torch.equal(torch.sort(ya).values, torch.sort(yc).values)


@pytest.mark.parametrize("name", ["explore_fs1", "explore_fs4"])
def test_mix_is_a_uniform_random_policy(name):
    mix = _mix(name)
    check_mix(mix)
    assert len(set(mix["actions"].values())) == 1 and set(mix["actions"]) == set(ACTIONS)
    s = make_stream(mix, 512, 7, "cpu")
    assert s.movement.shape == (STREAM_STEPS, 512, 2) and s.look.shape == (STREAM_STEPS, 512, 2)
    assert s.use.shape == (STREAM_STEPS, 512) and s.spawn_yaw.shape == (512,)
    turns = s.look[..., 0].abs()
    assert turns.unique().tolist() == [0.0, pytest.approx(mix["turn_rad"])]
    assert float(s.look[..., 1].abs().max()) == 0.0
    assert float(s.spawn_yaw.abs().max()) <= 3.1416
    n = STREAM_STEPS * 512
    for share, want in ((float(s.use.sum()) / n, 1 / 9),
                        (float((s.movement[..., 1] > 0).sum()) / n, 3 / 9),
                        (float((s.look[..., 0] > 0).sum()) / n, 2 / 9),
                        (float((s.movement[..., 0] != 0).sum()) / n, 2 / 9)):
        assert abs(share - want) < 0.005
    assert s.row(STREAM_STEPS + 3) == 3


def test_bad_mixes_raise():
    with pytest.raises(ValueError):
        check_mix(_mix(actions={"forward": 0.0, "use": 0.0}))
    with pytest.raises(ValueError):
        check_mix(_mix(actions={"jump": 1.0}))
    with pytest.raises(ValueError):
        check_mix(_mix(frame_skip=0))
    with pytest.raises(ValueError):
        check_mix(_mix(pool_seed=17))
