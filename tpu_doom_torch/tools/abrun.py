"""Measurements of two checkouts in turns, on one card, in one process
tree: the A/B runner the port's PERF.md numbers of a change against its
parent come from.

    python3 -m tpu_doom_torch.tools.abrun --other DIR --out DIR [SET ...]

DIR is another checkout of the repository (the parent: `git archive
<rev>` unpacked in a directory that .gitignore lists, such as build/).
Each command of each named set (default: all, in SETS' order) runs from
the other checkout's root and from this one's as `parent`, `change`,
and for the sets marked so again as `change`, `parent` (runs of one
card drift, so the order cancels a trend). Each run's standard output
and error go to OUT/<set>.<n>.<label>.txt; a line per run gives its
command, exit code and seconds. Exits 1 when any run fails.

Sets:
  stagebudget  `python3 -m tpu_doom_torch.tools.stagebudget` at four
               points: :test: 256 x 320x200; :test: 1,024 x 640x400
               (config 5's width and batch); :texstress: 256 x
               320x200; the same with portal_global_segs_max=1024
               (ABBA).
  profile      `python3 tools/profile_tick.py --rollout` (:test: 256 x
               320x200, eager and replayed) and `--bank 5 --batch 1024
               --width 640 --height 400` (config 5's tick) (AB).
  measure_all  `python3 -m tpu_doom_torch.tools.measure_all` (AB).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from .fixtures import ROOT

STAGEBUDGET = ("-m", "tpu_doom_torch.tools.stagebudget")
# set -> (ABBA?, [(added environment, python3 arguments)])
SETS = {
    "stagebudget": (True, [
        ({}, STAGEBUDGET),
        ({"BENCH_BATCH": "1024", "BENCH_W": "640", "BENCH_H": "400"}, STAGEBUDGET),
        ({"BENCH_WAD": ":texstress:"}, STAGEBUDGET),
        ({"BENCH_WAD": ":texstress:", "CFG": "portal_global_segs_max=1024"}, STAGEBUDGET),
    ]),
    "profile": (False, [
        ({}, ("tools/profile_tick.py", "--rollout")),
        ({}, ("tools/profile_tick.py", "--bank", "5", "--batch", "1024", "--width", "640",
              "--height", "400")),
    ]),
    "measure_all": (False, [({}, ("-m", "tpu_doom_torch.tools.measure_all"))]),
}
RUN_TIMEOUT = 1800  # seconds per run


def run(root: str, env: dict, args, log: str) -> tuple[int, float]:
    """`python3 args` from `root` with `env` added, output into `log`."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        try:
            rc = subprocess.run([sys.executable, *args], cwd=root, stdout=f,
                                stderr=subprocess.STDOUT, timeout=RUN_TIMEOUT,
                                env={**os.environ, **env}).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    return rc, time.perf_counter() - t0


def parse(argv=None):
    """The command line -> args; no set named means every set."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the parent's checkout")
    ap.add_argument("--out", required=True, help="directory for the runs' logs")
    # No default on the positional: argparse checks a list default against
    # the choices as one value, and refuses it.
    ap.add_argument("sets", nargs="*", choices=list(SETS))
    args = ap.parse_args(argv)
    args.sets = args.sets or list(SETS)
    return args


def main(argv=None) -> int:
    args = parse(argv)
    os.makedirs(args.out, exist_ok=True)
    roots = {"parent": os.path.abspath(args.other), "change": ROOT}
    failed = []
    for name in args.sets:
        abba, cmds = SETS[name]
        order = ("parent", "change", "change", "parent") if abba else ("parent", "change")
        for n, (env, cmd) in enumerate(cmds):
            for i, label in enumerate(order):
                log = os.path.join(args.out, f"{name}.{n}.{i}.{label}.txt")
                rc, secs = run(roots[label], env, cmd, log)
                words = " ".join([f"{k}={v}" for k, v in env.items()] + ["python3", *cmd])
                print(f"[abrun] {name} {label}: {words}: rc {rc} in {secs:.1f} s -> {log}",
                      flush=True)
                if rc != 0:
                    failed.append(log)
    if failed:
        print(f"[abrun] failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
