"""BENCHMARK.json against the contract it is written to: names, units,
keys, the files each name points to, and which cells report what."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(manifest):
    assert set(manifest) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
               for p in manifest["paths"])
    assert 1 <= len(manifest["command"]) <= 32 and all(_text(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    for section, lo, hi in (("configs", 1, 24), ("workloads", 1, 24), ("end_to_end", 1, 16),
                            ("per_layer", 1, 128)):
        entries = manifest[section]
        assert lo <= len(entries) <= hi
        for e in entries:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]


def test_names_units_and_text(manifest):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in ("device_trace", "program_span", "program_counter",
                                       "host_clock")
            text = {"configs": ("why", "source"), "workloads": ("why",),
                    "per_layer": ("layer",)}.get(section, ())
            assert all(_text(e[key]) for key in text), e["name"]
    assert len(names) == len(set(names))
    for c in manifest["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(pairs) // 4)


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m for m in manifest["end_to_end"]}["setup_s"]["bound"] <= 0.25


def test_check_fits_its_budget(manifest):
    # 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to compile and
    # 1200 s spare, with the full 24 cells.
    assert (2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_files_found_by_name(manifest):
    from harness.cell import Cell

    paths = manifest["paths"]
    for c in manifest["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert os.path.exists(os.path.join(BENCH, "drivers", conf["kind"] + ".py"))
        assert set(conf["limits"]) == {"state_err", "frame_px"}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        Cell(w["name"], manifest)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]


def test_every_cell_reports_what_it_must(manifest):
    from harness.cell import Cell

    e2e = {m["name"] for m in manifest["end_to_end"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
        for name in m.get("workloads", []):
            reported = {x["name"] for x in Cell(name, manifest).end_to_end()}
            assert m["moves"] in reported, (m["name"], name)
    for w in manifest["workloads"]:
        cell = Cell(w["name"], manifest)
        reported = {x["name"] for x in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.metrics("per_layer")
    roofs = [m for m in manifest["per_layer"] if m["name"].endswith("_roofline")]
    assert roofs and all(m["unit"] == "%" for m in roofs)


SPANS = {"step_ms", "walk_ms", "w2_roofline", "b2_roofline", "fallback_blocks",
         "device_idle_share", "step_span_ms", "walk_span_ms", "raster_span_ms",
         "fallback_span_ms", "frames_span_ms", "overflow_envs"}
BANK = {"migrate_span_ms", "migrated_envs"}


@pytest.mark.parametrize("cell, end_to_end, per_layer", [
    ("synth_b1024.fs1", {"env_frames_per_s", "setup_s"}, SPANS),
    ("synthbank4_b4096.fs1", {"env_frames_per_s", "agent_step_ms_p95", "setup_s"}, SPANS | BANK),
    ("synth_b1024.fs4", {"env_frames_per_s", "agent_step_ms_p95", "setup_s"}, SPANS),
    ("synthbank4_b4096.fs4", {"env_frames_per_s", "agent_step_ms_p95", "setup_s"},
     SPANS | BANK),
])
def test_cells_report_what_they_reported(manifest, cell, end_to_end, per_layer):
    """The metrics without a cell list reach the four cells by the rule of
    `Cell.metrics`, which gives each the set it reported when every
    per-layer metric listed them."""
    from harness.cell import Cell

    c = Cell(cell, manifest)
    assert {m["name"] for m in c.metrics("end_to_end")} == end_to_end
    assert {m["name"] for m in c.metrics("per_layer")} == per_layer


def test_cell_lists_only_where_a_metric_cannot_hold_for_every_cell(manifest):
    listed = {m["name"] for m in manifest["per_layer"] + manifest["end_to_end"]
              if "workloads" in m}
    # The bank's migration; two outside timings queued for retirement; the
    # p95 left out of synth_b1024.fs1 for its spread.
    assert listed == {"migrate_span_ms", "migrated_envs", "step_ms", "walk_ms",
                      "agent_step_ms_p95"}
