"""Rerun every performance row of the port, one process at a time: the
twin of tools/measure_all.sh.

    python3 -m tpu_doom_torch.tools.measure_all

Each row of ROWS runs as `python3 -m <module> [args]` from the checkout's
root with its variables added to the environment, under a time limit;
prints `=== <vars> python3 -m <module> [args] ===`, then the last line of
its standard output (a JSON line), the lines of its standard error that
carry the frames' checksum (the bench rows': two checkouts that render
the same frames on the same trajectory print the same), then its exit
code and seconds. The
first five rows are the shell script's bench rows, then its verify row,
then the three bench points of the benchmark's candidate cells that the
script lacks. The script's fallback rate row has no twin: the port counts
the envs that leave the portal path on the device (trace.py's
`overflow_envs`). Exits 1, naming them, when any row fails,
times out or prints nothing: a failed row is no measurement. On the card:
every row asks for it, as the modules do.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from .fixtures import ROOT

BENCH = ("tpu_doom_torch.bench",)
ROW_TIMEOUT = 900  # seconds per row
# (added environment, `python3 -m` arguments, time limit in seconds)
ROWS = (
    ({}, BENCH, ROW_TIMEOUT),  # the bench defaults: :test:, 256 x 320x200
    ({"BENCH_LOOKY": "1"}, BENCH, ROW_TIMEOUT),  # free look
    ({"BENCH_WAD": ":texstress:"}, BENCH, ROW_TIMEOUT),  # a maze's texel volume
    ({"BENCH_BANK": "1"}, BENCH, ROW_TIMEOUT),  # config 5: 4 x 1024 at 640x400
    ({"BENCH_BANK": "1", "BENCH_LEVELS": "8"}, BENCH, ROW_TIMEOUT),  # the L=8 bank
    ({}, BENCH + ("--verify",), 2 * ROW_TIMEOUT),  # every verify leg
    ({"BENCH_WAD": ":texstress:", "BENCH_GLOBAL_MAX": "1024"}, BENCH,
     ROW_TIMEOUT),  # the active set
    ({"BENCH_BATCH": "1024"}, BENCH, ROW_TIMEOUT),  # BASELINE config 4
    ({"BENCH_BATCH": "4096"}, BENCH, ROW_TIMEOUT),
)


def row_label(env: dict, args: tuple) -> str:
    return " ".join([f"{k}={v}" for k, v in env.items()] + ["python3 -m", *args])


def run_row(env: dict, args: tuple, timeout: float) -> tuple[bool, str]:
    """Run one row -> (whether it succeeded, its report lines)."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env={**os.environ, **env},
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return False, f"timed out after {timeout} s"
    secs = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    ok = r.returncode == 0 and bool(lines)
    report = ([lines[-1] if lines else "(no output)"]
              + [x for x in r.stderr.splitlines() if ", checksum " in x]
              + [f"rc {r.returncode} in {secs:.1f} s"])
    if not ok:
        report += r.stderr.strip().splitlines()[-5:]
    return ok, "\n".join(report)


def main() -> int:
    failed = []
    for env, args, timeout in ROWS:
        label = row_label(env, args)
        print(f"=== {label} ===", flush=True)
        ok, report = run_row(env, args, timeout)
        print(report, flush=True)
        if not ok:
            failed.append(label)
    if failed:
        print(f"measure_all: {len(failed)} row(s) failed: " + "; ".join(failed),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
