"""`tpu_doom_torch.trace` on the CPU, where spans take the host clock at
the same boundaries as the card's device stamps: tracing off changes and
records nothing, tracing on leaves every output as it was, the span trees
of a rollout and of a bank tick, the two counters against the eager
counts, and the ring's dropped ticks. (The card tests in
tests/test_torch_cuda.py count the captured graphs' nodes and hold the
stamps to a profiler trace.)"""

import contextlib
import os

import numpy as np
import pytest
import torch

from tpu_doom_torch import ops, trace
from tpu_doom_torch.models import DoomSim, LevelBank
from tpu_doom_torch.sim.state import Actions
from tpu_doom_torch.utils.config import GameConfig, PlayerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, B = 64, 40, 4
EXIT_POS = [-2.56, 0.68, -14.7]  # :test: level 0's exit switch (tests/test_torch_bank.py)
STEP_KIDS = ("effects", "player", "triggers")
RENDER_KIDS = ("walk", "raster", "fallback")


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    yield
    trace.disable()


def _sim(**kw):
    """:test: at 64x40 with half the envs pitched under
    portal_pitch="triangle": they take the triangle fallback."""
    sim = DoomSim(GameConfig(wad_file=":test:", width=W, height=H, batch_size=B,
                             raster_backend="portal", portal_pitch="triangle",
                             player=PlayerConfig(clip_substeps=4), **kw), "cpu")
    s0 = sim.reset()
    return sim, s0._replace(pitch=torch.tensor([0.3, 0.0, -0.2, 0.0]))


def _seq(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    off = torch.zeros((n, B), dtype=torch.bool)
    return Actions(movement=torch.rand((n, B, 2), generator=g) * 2 - 1,
                   look=torch.rand((n, B, 2), generator=g) * 0.1 - 0.05, jump=off,
                   fly_toggle=off, clip_toggle=off,
                   push=torch.rand((n, B), generator=g) < 0.3, shoot=off)


def _rollout(sim, s0, n, every):
    ops.reset_launch_counts()
    state, frames = sim.rollout(s0, _seq(n), n, render_every=every)
    return [*state, frames], ops.launch_counts()


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_tracing_off_changes_and_records_nothing(monkeypatch):
    """With tracing off a rollout's state, frames and launch counts are
    those of one with every span and count of `trace` replaced by nothing
    (as before tracing existed), and nothing is recorded meanwhile."""
    sim, s0 = _sim()
    with monkeypatch.context() as m:
        for name in ("span", "host_span", "tick_span"):
            m.setattr(trace, name, lambda *a, **k: contextlib.nullcontext())
        m.setattr(trace, "count", lambda *a, **k: None)
        before = _rollout(sim, s0, 3, 1)
    trace.enable("cpu")
    trace.disable()
    off = _rollout(sim, s0, 3, 1)
    assert _equal(off[0], before[0]) and off[1] == before[1]
    assert trace.session() is None
    trace.enable("cpu")
    rec = trace.spans()
    assert rec.spans == [] and trace.counts() == {
        "overflow_envs": 0, "migrated_envs": 0, "cull_overflow_envs": 0, "visible_rows": 0}


@pytest.mark.parametrize("every", [1, 4])
def test_tracing_on_leaves_outputs_as_off(every):
    sim, s0 = _sim()
    off = _rollout(sim, s0, 4, every)
    trace.enable("cpu")
    on = _rollout(sim, s0, 4, every)
    assert _equal(on[0], off[0]) and on[1] == off[1]
    assert trace.spans().spans


def _check_tree(rec):
    """Every child inside its parent and of its parent's tick (host spans
    of a rollout's later ticks excepted: their parent is the call), siblings
    disjoint, parents listed before their children."""
    spans = rec.spans
    kids: dict = {}
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
            assert s.tick == p.tick or p.name == "host.rollout", (p, s)
        kids.setdefault(s.parent, []).append(s)
    for group in kids.values():
        for kind in (True, False):  # host spans and program spans apart
            same = sorted((s for s in group if s.name.startswith(trace.HOST) == kind),
                          key=lambda s: s.start_ns)
            for a, b in zip(same, same[1:]):
                assert a.end_ns <= b.start_ns, (a, b)


def _children(rec, span) -> list:
    i = rec.spans.index(span)
    return [s.name for s in rec.spans if s.parent == i]


@pytest.mark.parametrize("every", [1, 4])
def test_rollout_span_tree(every):
    """A rollout of 8 tics: one `tick` a tic, with `step` (effects, player,
    triggers) and on rendered tics `render` (walk, raster, fallback);
    outside the ticks `actions` before each and `frames` after each
    rendered one, under the same tick ids as their host spans; the call's
    host.rollout under the first tick's id."""
    sim, s0 = _sim()
    n = 8
    sim.rollout(s0, None, 2)  # the graphs of the CPU are none: nothing to warm
    trace.enable("cpu")
    sim.rollout(s0, _seq(n), n, render_every=every)
    rec = trace.spans()
    _check_tree(rec)
    assert (rec.first_tick, rec.last_tick, rec.dropped_ticks) == (1, n, 0)
    ticks = [s for s in rec.spans if s.name == "tick"]
    assert [s.tick for s in ticks] == list(range(1, n + 1))
    assert all(s.parent < 0 for s in ticks)
    for t, s in enumerate(ticks, 1):
        rendered = t % every == 0
        assert _children(rec, s) == (["step", "render"] if rendered else ["step"])
        step = next(c for c in rec.spans if c.name == "step" and c.tick == t)
        assert _children(rec, step) == list(STEP_KIDS)
        if rendered:
            render = next(c for c in rec.spans if c.name == "render" and c.tick == t)
            assert _children(rec, render) == list(RENDER_KIDS)
    for name, count in (("actions", n), ("frames", n // every)):
        dev = [s.tick for s in rec.spans if s.name == name]
        host = [s.tick for s in rec.spans if s.name == trace.HOST + name]
        assert dev == host and len(dev) == count, name
        assert all(s.parent < 0 for s in rec.spans if s.name == name)
    call, = (s for s in rec.spans if s.name == "host.rollout")
    assert call.tick == 1 and call.parent < 0
    assert all(rec.spans[s.parent] is call for s in rec.spans
               if s.name in ("host.actions", "host.frames"))
    assert 0.0 <= rec.idle_share() <= 100.0


def _bank(**kw):
    from tpu_doom_torch.geom.builder import compile_level
    from tpu_doom_torch.models.doom_sim import open_wad
    from tpu_doom_torch.wad.meta import WadMetadata
    from tpu_doom_torch.wad.tex import TextureDirectory

    meta = WadMetadata.from_file(os.path.join(ROOT, "assets/meta/doom.toml"))
    wad = open_wad(":test:")
    levels = [compile_level(wad, TextureDirectory(wad, meta), meta, i) for i in (0, 1)]
    cfg = GameConfig(wad_file=":test:", width=W, height=H, raster_backend="portal",
                     player=PlayerConfig(clip_substeps=1, enable_noclip=False), **kw)
    return LevelBank(levels, cfg, "cpu")


def _bank_start(bank):
    """Two levels of two envs; env (0, 0) at level 0's exit switch, pushing,
    one free slot in level 1: it migrates on the first tic."""
    s = bank.reset(2)
    pos = s.pos.clone()
    pos[0, 0] = torch.tensor(EXIT_POS)
    active = torch.tensor([[True, True], [True, False]])
    push = torch.zeros((2, 2), dtype=torch.bool)
    push[0, 0] = True
    z = torch.zeros((2, 2), dtype=torch.bool)
    acts = Actions(movement=torch.zeros((2, 2, 2)), look=torch.zeros((2, 2, 2)), jump=z,
                   fly_toggle=z, clip_toggle=z, push=push, shoot=z)
    return s._replace(pos=pos), active, acts


def test_bank_tick_span_tree():
    """A two-level bank tick in a caller's `tick` span: a `step` per level,
    `migrate`, a `render` per level, then `frames`, all of that tick; the
    same tick called eagerly opens its own tick at `step_with_exits`."""
    bank = _bank()
    s, active, acts = _bank_start(bank)
    trace.enable("cpu")
    with trace.span("tick"):
        s1, a1, _ = bank.step_with_exits(s, active, acts)
        bank.render(s1)
    bank.step_with_exits(s1, a1, acts)  # eagerly: a tick of its own
    rec = trace.spans()
    _check_tree(rec)
    tick1, tick2 = (s for s in rec.spans if s.name == "tick")
    assert (tick1.tick, tick2.tick) == (1, 2)
    assert _children(rec, tick1) == ["step", "step", "migrate", "render", "render", "frames"]
    assert _children(rec, tick2) == ["step", "step", "migrate"]
    for step in (s for s in rec.spans if s.name == "step"):
        assert _children(rec, step) == list(STEP_KIDS)
    for render in (s for s in rec.spans if s.name == "render"):
        assert _children(rec, render) == list(RENDER_KIDS)


def test_migrated_envs_is_the_summed_moves():
    bank = _bank()
    s, active, acts = _bank_start(bank)
    trace.enable("cpu")
    moves = 0
    for _ in range(3):
        s, active, moved = bank.step_with_exits(s, active, acts)
        moves += int(moved.sum())
    assert moves == 1
    assert trace.counts()["migrated_envs"] == moves


@pytest.mark.parametrize("decide_on_device", [False, True], ids=["host", "device"])
def test_overflow_envs_is_the_eager_fallback_count(monkeypatch, decide_on_device):
    """overflow_envs sums the envs each frame sends to the triangle
    fallback, as the eager path counts them; each frame renders at least
    ceil(fallen / 32) fallback blocks (the fallen envs at once on the
    host's form, every block of 32 on the device's)."""
    from tpu_doom_torch.graphs import device_decisions
    from tpu_doom_torch.render import portal as P

    blocks = []
    render_frames = P.render_frames

    def counted(*args):
        blocks[-1] += 1
        return render_frames(*args)

    monkeypatch.setattr(P, "render_frames", counted)
    sim, s = _sim(portal_crossings=2)  # few crossings kept: columns overflow too
    seq = _seq(4, seed=3)
    trace.enable("cpu")
    want = 0
    for t in range(4):
        s = sim.step(s, Actions(*(x[t] for x in seq)))
        overflow = P.render_portal_zero_pitch(sim.portal_scene(), sim.scene, sim.config, s,
                                              W, H)[2]
        fallen = int(((s.pitch.abs() > P.PITCH_EPS) | overflow).sum())
        want += fallen
        blocks.append(0)
        with device_decisions() if decide_on_device else contextlib.nullcontext():
            sim.render(s)
        assert blocks[-1] >= -(-fallen // P.FALLBACK_ENVS), (t, blocks, fallen)
    assert want > 0
    assert trace.counts()["overflow_envs"] == want


def test_counter_counts_with_tracing_off(monkeypatch):
    """A counter made with tracing off (`trace.counter`, as chip_smoke
    reads the fallback's share) counts a rollout as tracing's own
    `counts()` does, and nothing is counted on a device before its counters
    are made."""
    monkeypatch.setattr(trace, "_counters", {})
    sim, s0 = _sim()
    sim.rollout(s0, _seq(4), 4, render_every=1)
    assert trace._counters == {}
    fallen = trace.counter("overflow_envs", "cpu")
    sim.rollout(s0, _seq(4), 4, render_every=1)
    off = int(fallen)
    trace.enable("cpu")
    assert int(fallen) == 0  # enable() zeroes it
    sim.rollout(s0, _seq(4), 4, render_every=1)
    assert off > 0 and trace.counts() == {
        "overflow_envs": off, "migrated_envs": 0, "cull_overflow_envs": 0, "visible_rows": 0}


BIG = ":texstress:10x16"  # 257 walk rows: the cull (to 256), B4's selection, W2 reading it


def _big_sim(**kw):
    """:texstress:10x16 at 64x40, the four envs facing four ways."""
    sim = DoomSim(GameConfig(wad_file=BIG, width=W, height=H, batch_size=B,
                             raster_backend="portal",
                             player=PlayerConfig(clip_substeps=4), **kw), "cpu")
    s0 = sim.reset()
    return sim, s0._replace(yaw=torch.tensor([0.0, 1.6, 3.2, 4.8]))


def _plain_visible(monkeypatch):
    """Spy on W0's calls in the walk: each call's count of visible rows
    per env and overflow, both from the plain cull (`_visible_rows` on
    the level's uncut endpoints, `walk_table_ref` with no budget), and
    its budget SV."""
    from tpu_doom_torch.render import portal as P

    seen = []
    walk_table = P.walk_table

    def spied(*targs):
        sv = targs[10]
        _, p1, p2, *_ = P.walk_table_ref(*targs[:10], 0, *targs[11:])
        pt, _, _, _, right, fwd, o, p00, near, far = targs[:10]
        n = P._visible_rows(p1, p2, o, fwd, right, p00, near, far).sum(dim=1)
        seen.append((sv, n, n > sv))
        return walk_table(*targs)

    monkeypatch.setattr(P, "walk_table", spied)
    return seen


@pytest.mark.parametrize("every", [1, 2])
def test_big_level_rollout_span_tree(every):
    """On a big level `walk` holds a `select` span (kernel B4) on every
    rendered tic, and `select` opens nowhere else: one per render."""
    sim, s0 = _big_sim()
    n = 4
    trace.enable("cpu")
    sim.rollout(s0, _seq(n), n, render_every=every)
    rec = trace.spans()
    _check_tree(rec)
    walks = [s for s in rec.spans if s.name == "walk"]
    assert len(walks) == n // every
    for w in walks:
        assert _children(rec, w) == ["select"]
    selects = [s for s in rec.spans if s.name == "select"]
    assert len(selects) == len(walks)
    assert all(rec.spans[s.parent].name == "walk" for s in selects)
    for render in (s for s in rec.spans if s.name == "render"):
        assert _children(rec, render) == list(RENDER_KIDS)


def test_visible_rows_is_the_plain_culls_count(monkeypatch):
    """visible_rows sums, over the rendered tics, each env's visible rows
    as the plain cull counts them; every env fits the AUTO budget here,
    so cull_overflow_envs reads 0."""
    seen = _plain_visible(monkeypatch)
    sim, s0 = _big_sim()
    trace.enable("cpu")
    sim.rollout(s0, _seq(4), 4, render_every=2)
    assert len(seen) == 2 and all(sv == 256 for sv, _, _ in seen)
    counts = trace.counts()
    assert counts["visible_rows"] == sum(int(n.sum()) for _, n, _ in seen) > 0
    assert counts["cull_overflow_envs"] == sum(int(o.sum()) for _, _, o in seen) == 0


def test_cull_overflow_envs_is_the_plain_culls_overflow(monkeypatch):
    """With the visible-row budget forced down to 64 rows,
    cull_overflow_envs sums the envs the plain cull sends over it; on
    :test: (no cull) both cull counters read 0."""
    seen = _plain_visible(monkeypatch)
    sim, s0 = _big_sim(portal_visible_segs=64)
    trace.enable("cpu")
    sim.rollout(s0, _seq(2), 2, render_every=1)
    assert len(seen) == 2 and all(sv == 64 for sv, _, _ in seen)
    counts = trace.counts()
    want = sum(int(o.sum()) for _, _, o in seen)
    assert counts["cull_overflow_envs"] == want > 0
    assert counts["visible_rows"] == sum(int(n.sum()) for _, n, _ in seen)
    assert counts["overflow_envs"] >= want

    seen.clear()
    sim, s0 = _sim()
    trace.reset()
    sim.rollout(s0, _seq(2), 2, render_every=1)
    assert seen and all(sv == 0 for sv, _, _ in seen)
    counts = trace.counts()
    assert counts["cull_overflow_envs"] == counts["visible_rows"] == 0


@pytest.mark.parametrize("every", [1, 2])
def test_big_level_tracing_on_leaves_outputs_as_off(every):
    sim, s0 = _big_sim()
    off = _rollout(sim, s0, 4, every)
    trace.enable("cpu")
    on = _rollout(sim, s0, 4, every)
    assert _equal(on[0], off[0]) and on[1] == off[1]
    assert trace.counts()["visible_rows"] > 0


def test_ring_wrap_reports_dropped_ticks(monkeypatch):
    """A ring of 4 ticks read after 10: the last 4 are returned whole, the 6
    before them counted as dropped; the next read starts after them."""
    sim, s0 = _sim()
    monkeypatch.setattr(trace, "RING_TICKS", 4)
    trace.enable("cpu")
    state, _ = sim.rollout(s0, None, 10, render_every=2)
    rec = trace.spans()
    assert (rec.first_tick, rec.last_tick, rec.dropped_ticks) == (7, 10, 6)
    assert [s.tick for s in rec.spans if s.name == "tick"] == [7, 8, 9, 10]
    _check_tree(rec)
    sim.rollout(state, None, 2, render_every=2)
    rec = trace.spans()
    assert (rec.first_tick, rec.last_tick, rec.dropped_ticks) == (11, 12, 0)
    assert np.isfinite(rec.idle_share())
