"""The port's timing tools (`tpu_doom_torch.tools.perfcmp`, `stagebudget`,
`measure_all`) against the JAX package's root tools they twin, loaded
from their files under tools/, on the CPU (the kernels' plain versions;
no time here is a device time).

Tolerances: all exact.
(a) `parse` equals tools/perfcmp.py's on a table of groups, results and
    SystemExit alike; the config a group gives equals the JAX tool's,
    field by field (the metadata path aside: the port's tools name the
    checkout's file by its absolute path).
(b) `perfcmp.run_one` and each `stagebudget` stage at 2 envs x 64x40, 2
    ticks: finite, positive; the `full` stage's checksum equals
    `bench.time_ticks`' over the same ticks from reset, bitwise.
(c) `measure_all`: its first five rows are tools/measure_all.sh's `run`
    lines; a failing, silent or timed-out row makes it exit 1.
"""

import dataclasses
import math
import os
import subprocess

import pytest
import torch
from test_torch_tools import _load_jax_tool

from tpu_doom_torch.tools import measure_all as MA
from tpu_doom_torch.tools import perfcmp as PC
from tpu_doom_torch.tools import stagebudget as SB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = PC.Point(":test:", batch=2, width=64, height=40, ticks=2, reps=1)


@pytest.fixture(scope="module")
def perfcmp_jax():
    return _load_jax_tool("perfcmp")


# ---------------------------------------------------------------------------
# (a) perfcmp's parse and config split
# ---------------------------------------------------------------------------

GROUPS = ["", "a", "portal_crossings=12", "radius=0.2", "x=-3", "y=1e-3", "b=True",
          "b=False", "raster_backend=portal_jnp", "s=a=b",
          "portal_crossings=12,radius=0.25,portal_select_rows=off", "ENV.X=1",
          "ENV.X=1,portal_compact_crossings=4", "a=1,b"]


def _outcome(fn, group):
    try:
        return fn(group)
    except SystemExit as exc:
        return ("SystemExit", str(exc))


@pytest.mark.parametrize("group", GROUPS)
def test_parse_matches_perfcmp(perfcmp_jax, group):
    """(a) The same dict, types included, or the same SystemExit."""
    want, got = _outcome(perfcmp_jax.parse, group), _outcome(PC.parse, group)
    assert got == want
    if isinstance(want, dict):  # True == 1: the types too
        assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert isinstance(want, tuple) == (group in ("", "a", "a=1,b"))


@pytest.mark.parametrize("group", [
    "", "portal_crossings=12,radius=0.25", "enable_noclip=True,portal_select_rows=off",
    "portal_global_segs_max=1024,height=0.3"])
def test_config_split_matches_perfcmp(group, monkeypatch):
    """(a) `split_overrides` and the GameConfig built from it equal the
    JAX tool's (tools/perfcmp.py:52-76) field by field."""
    from tpu_doom.utils.config import GameConfig, PlayerConfig

    ov = PC.parse(group) if group else {}
    pfields = {f.name for f in dataclasses.fields(PlayerConfig)}
    want_p = {k: v for k, v in ov.items() if k in pfields}
    want_g = {k: v for k, v in ov.items() if k not in pfields}
    assert PC.split_overrides(ov) == (want_p, want_g)
    for k in ("BENCH_WAD", "BENCH_BATCH", "BENCH_W", "BENCH_H"):
        monkeypatch.delenv(k, raising=False)
    want = GameConfig(wad_file=":test:", width=320, height=200, batch_size=256,
                      raster_backend="portal",
                      player=PlayerConfig(clip_substeps=4, **want_p), **want_g)
    got = PC.bench_config(PC.Point.from_env(), ov)
    want, got = dataclasses.asdict(want), dataclasses.asdict(got)
    assert got.pop("metadata_file") == os.path.join(ROOT, want.pop("metadata_file"))
    assert got == want


# ---------------------------------------------------------------------------
# (b) perfcmp.run_one and the stages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_sim():
    return PC.make_sim(PC.bench_config(SMALL, {}), "cpu")


@pytest.mark.parametrize("group", ["", "portal_compact_crossings=4,radius=0.2"])
def test_run_one_on_cpu(group):
    """(b) env*frames/s of the bench's tick, finite and positive; a shared
    sim runs each group under its own config."""
    sims = {}
    fps = PC.run_one(PC.parse(group) if group else {}, "cpu", sims, SMALL)
    assert math.isfinite(fps) and fps > 0
    (sim,) = sims.values()
    assert sim.config == PC.bench_config(SMALL, PC.parse(group) if group else {})


def test_perfcmp_main_restores_the_environment(monkeypatch, capsys):
    """(b) An ENV. group sets its variables for its run only: a variable
    that was set gets its value back, one that was not is removed."""
    for k, v in (("BENCH_DEVICE", "cpu"), ("BENCH_BATCH", "2"), ("BENCH_W", "64"),
                 ("BENCH_H", "40"), ("BENCH_TICKS", "2"), ("BENCH_CHUNK", "2"),
                 ("BENCH_REPS", "1"), ("PERFCMP_HOOK_A", "kept")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("PERFCMP_HOOK_B", raising=False)
    seen = []
    real = PC.run_one

    def spy(ov, device, sims, point):
        seen.append((os.environ.get("PERFCMP_HOOK_A"), os.environ.get("PERFCMP_HOOK_B"),
                     sims is None))
        return real(ov, device, sims, point)

    monkeypatch.setattr(PC, "run_one", spy)
    before = dict(os.environ)
    assert PC.main(["", "ENV.PERFCMP_HOOK_A=1,ENV.PERFCMP_HOOK_B=2,radius=0.2"]) == 0
    assert dict(os.environ) == before
    assert seen == [("kept", None, False), ("1", "2", True)]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[perfcmp] :test: 64x40 x 2 envs on cpu")
    assert [ln.split(": ")[0] for ln in lines[1:]] == [
        "(default)", "ENV.PERFCMP_HOOK_A=1,ENV.PERFCMP_HOOK_B=2,radius=0.2"]
    assert all(ln.endswith(" env-fps") for ln in lines[1:])


@pytest.mark.parametrize("stage", SB.STAGES)
def test_stage_on_cpu(small_sim, stage):
    """(b) Each stage's ms per tick is finite and positive and its
    checksum non-zero."""
    ms, (state, check) = SB.run_stage(stage, small_sim, SMALL)
    assert math.isfinite(ms) and ms > 0
    assert int(check) != 0
    assert state.pos.shape == (SMALL.batch, 3)


def test_full_stage_is_the_bench_tick(small_sim):
    """(b) The full stage's checksum after its warm-up and windows is
    bitwise the bench's `time_ticks` checksum over as many ticks from
    reset."""
    from tpu_doom_torch.bench import bench_actions, sim_tick, time_ticks

    point = SMALL._replace(reps=2)
    _, (_, check) = SB.run_stage("full", small_sim, point)
    state = (small_sim.reset(point.batch), torch.zeros((), dtype=torch.int64))
    want = time_ticks(sim_tick(small_sim, point.width, point.height), state,
                      bench_actions(small_sim, point.batch), point.reps * point.ticks,
                      warmup=1).state[-1]
    assert int(check) == int(want) > 0


def test_walk_checksum_reads_a_fixed_sample():
    """(b) The walk stage's checksum reads WALK_SAMPLE elements spread over
    each output, whatever its size, and refuses to copy a strided one."""
    one = 0x3F800000  # the bits of 1.0f
    for n in (SB.WALK_SAMPLE // 3, SB.WALK_SAMPLE, 10 * SB.WALK_SAMPLE + 3):
        x = torch.ones(n)
        assert int(SB.sample_sum(x)) == one * min(n, SB.WALK_SAMPLE)
    ramp = torch.arange(8 * SB.WALK_SAMPLE, dtype=torch.int32).reshape(8, -1)
    assert int(SB.sample_sum(ramp)) == 8 * SB.WALK_SAMPLE * (SB.WALK_SAMPLE - 1) // 2
    with pytest.raises(RuntimeError):
        SB.sample_sum(ramp.t())


def test_stagebudget_main_and_unknown_stage(monkeypatch, capsys):
    """(b) `main` prints the JAX tool's lines; `kernel`, named in the JAX
    tool's usage line but without a body there, exits with a message."""
    for k, v in (("BENCH_DEVICE", "cpu"), ("BENCH_BATCH", "2"), ("BENCH_W", "64"),
                 ("BENCH_H", "40"), ("BENCH_TICKS", "1"), ("BENCH_CHUNK", "1"),
                 ("BENCH_REPS", "1"), ("CFG", "portal_crossings=12")):
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="unknown stage.*kernel"):
        SB.main(["kernel"])
    assert SB.main(["full", "step", "render"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[stagebudget] :test: 64x40 x 2 envs on cpu")
    assert [ln.split(":")[0].strip() for ln in lines[1:4]] == ["full", "step", "render"]
    assert all("ms/tick (B=2)" in ln and ln.endswith("env-fps]") for ln in lines[1:4])
    assert lines[4].startswith("  (step+render - full overlap: ")


# ---------------------------------------------------------------------------
# (c) measure_all
# ---------------------------------------------------------------------------


def _shell_rows():
    """The environments of tools/measure_all.sh's `run` lines."""
    rows = []
    with open(os.path.join(ROOT, "tools", "measure_all.sh")) as f:
        for line in f:
            words = line.split("#")[0].split()
            if words[:1] == ["run"]:
                rows.append(dict(w.split("=", 1) for w in words[1:]))
    return rows


def test_measure_all_rows_start_with_the_shell_rows():
    """(c) The shell script's five bench rows, in order, then its verify
    row, then the three points it lacks (the script's fallback rate row
    has no twin: the walk's overflow is the port's `overflow_envs`
    counter)."""
    shell = _shell_rows()
    assert len(shell) == 5
    assert [env for env, _, _ in MA.ROWS[:5]] == shell
    assert all(args == MA.BENCH for _, args, _ in MA.ROWS[:5])
    assert MA.ROWS[5][1] == MA.BENCH + ("--verify",)
    assert [env for env, _, _ in MA.ROWS[6:]] == [
        {"BENCH_WAD": ":texstress:", "BENCH_GLOBAL_MAX": "1024"},
        {"BENCH_BATCH": "1024"}, {"BENCH_BATCH": "4096"}]


@pytest.mark.parametrize("fault", [None, "fails", "silent", "times_out"])
def test_measure_all_exit_code(fault, monkeypatch, capsys):
    """(c) Exit 0 when every row succeeds, else 1 with the row named; every
    row runs, one at a time, with its own time limit; each row's report
    carries its checksum line from standard error."""
    calls = []

    def fake_run(cmd, cwd, env, capture_output, text, timeout):
        calls.append((tuple(cmd[2:]), env.get("BENCH_LOOKY"), timeout))
        bad = fault is not None and env.get("BENCH_LOOKY") == "1"
        if bad and fault == "times_out":
            raise subprocess.TimeoutExpired(cmd, timeout)
        out = "" if bad and fault == "silent" else "set-up\n{\"value\": 1.0}\n"
        return subprocess.CompletedProcess(cmd, 1 if bad and fault == "fails" else 0,
                                           out, "bench: timed 1.0s, checksum 77\na traceback")

    monkeypatch.setattr(MA.subprocess, "run", fake_run)
    rc = MA.main()
    out, err = capsys.readouterr()
    assert len(calls) == len(MA.ROWS)
    assert calls[1] == (MA.BENCH, "1", MA.ROW_TIMEOUT)
    assert out.count("=== ") == len(MA.ROWS)
    assert "=== BENCH_LOOKY=1 python3 -m tpu_doom_torch.bench ===" in out
    if fault is None:
        assert rc == 0 and err == ""
        assert out.count('{"value": 1.0}') == len(MA.ROWS)
        assert out.count("bench: timed 1.0s, checksum 77") == len(MA.ROWS)
        assert "a traceback" not in out
    else:
        assert rc == 1
        assert "1 row(s) failed: BENCH_LOOKY=1 python3 -m tpu_doom_torch.bench" in err
