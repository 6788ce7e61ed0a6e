"""Tiny CPU runs of one cell of each kind with --trace 1, the span window
(`harness/spans.py`) let run on the CPU (where by default it runs no
step and reports nothing): it reports every span metric its cell lists,
finite and in range, and the per-layer metrics that were there before
read as they read without the span metrics."""

import json
import math
import os

import pytest

import harness.cell as hc
import harness.spans as spans
from conftest import ROOT, SMALL
from harness.cell import run_cell

SEED = 2**31 + 4242
SPAN_METRICS = ("device_idle_share", "step_span_ms", "walk_span_ms", "raster_span_ms",
                "fallback_span_ms", "frames_span_ms", "migrate_span_ms", "overflow_envs",
                "migrated_envs")


def _manifest(with_spans: bool) -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    if not with_spans:
        m["per_layer"] = [e for e in m["per_layer"] if e["name"] not in SPAN_METRICS]
    return m


def _run(monkeypatch, cell, with_spans):
    over = dict(SMALL)
    if cell.startswith("synthbank"):
        over.update(envs_per_level=2, warmup_steps=1)
    manifest = _manifest(with_spans)
    monkeypatch.setattr(hc, "load_json", lambda path, load=hc.load_json: (
        manifest if path == hc.MANIFEST else load(path)))
    monkeypatch.setattr(spans, "CPU_STEPS", 4)
    return run_cell(cell, SEED, 0.3, True, "cpu", overrides=over, log=lambda line: None)


@pytest.mark.parametrize("cell", ["synth_b1024.fs4", "synthbank4_b4096.fs1"])
def test_traced_run_reports_the_span_metrics(monkeypatch, cell):
    res = _run(monkeypatch, cell, True)
    assert res["correct"], res["checks"]
    listed = {e["name"] for e in _manifest(True)["per_layer"]
              if e["name"] in SPAN_METRICS and cell in e["workloads"]}
    assert len(listed) == (9 if cell.startswith("synthbank") else 7)
    got = res["metrics"]
    assert listed <= set(got)
    for name in listed:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0, name
    assert got["device_idle_share"]["value"] <= 100
    for name in ("step_span_ms", "walk_span_ms", "raster_span_ms"):
        assert got[name]["value"] > 0, name
    if cell.startswith("synthbank"):
        assert got["migrate_span_ms"]["value"] > 0

    # Without the span metrics the metrics that were there read the same:
    # the span window runs after their readers and touches nothing they read.
    # step_ms is a host-clock time, so it is only present in both.
    before = _run(monkeypatch, cell, False)["metrics"]
    assert set(before) == set(got) - listed
    for name, m in before.items():
        if name != "step_ms":
            assert got[name]["value"] == m["value"], name
