#!/usr/bin/env python3
"""B3 (`peel_resolve`) and B9 (`depth_peel`) timed on the card at two shapes.

    python3 tpu_doom_torch/tools/peelbench.py [--label NAME] [--out DIR]

(DIR defaults to build/, which git ignores.)

Times the kernels of the checkout in the current directory, so that two
revisions can be compared in one run on one card: run it from the
root of each (`cd other && python3 /path/to/peelbench.py --label other`).
The shapes, both 320x200 at K = depth_layers = 3, from chip_smoke.py's
own input makers in that checkout:
  verify  the 8 verify poses of :test: (tests/golden/verify_ref.npz);
  maze    a maze's triangles: the 128 pitched envs of chip_smoke.py's
          fallback_sim on :texstress: at reset.
For each kernel and shape: the median ms of single launches and of runs
of 5 launches back to back (CUDA events), and a SHA-256 of the output's
bytes, which two revisions' kernels give alike when they agree bit for
bit. Prints one line each and writes them as JSON to
DIR/peelbench_NAME.json, beside the card's name and power limit. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys

import numpy as np
import torch

W, H = 320, 200


def states():
    """shape name -> (sim, state), from the checkout's chip_smoke.py."""
    from chip_smoke import fallback_sim, make_sim, verify_ref, verify_state

    vsim = make_sim(batch_size=8, portal_crossings=12, raster_backend="auto")
    sim, state, _ = fallback_sim(wad_file=":texstress:")
    n = state.pos.shape[0] // 2  # fallback_sim pitches the first half
    return {"verify": (vsim, verify_state(vsim, verify_ref())),
            "maze": (sim, type(state)(*(x[:n] for x in state)))}


def taken(fn, **kw):
    """The keyword arguments of kw that fn's signature takes (revisions
    differ in tile_p / chunk_t / width)."""
    names = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k in names}


def ms(fn, calls, per_run):
    """Median ms per launch over `calls` runs of `per_run` launches."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return float(np.median(times))


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="checkout")
    ap.add_argument("--out", default="build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("peelbench: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())  # the checkout to time
    from tpu_doom_torch.ops import depth_peel, pack_triangle_rows, peel_resolve
    from tpu_doom_torch.render import raster as R
    from tpu_doom_torch.tools import device_label

    card = device_label(torch.device("cuda"))
    rows = []
    for shape, (sim, state) in states().items():
        cfg = sim.config
        K = cfg.depth_layers
        kw = dict(tile_p=cfg.raster_tile_p, chunk_t=cfg.raster_chunk_t, width=W)
        b3_kw, b9_kw = taken(peel_resolve, **kw), taken(depth_peel, **kw)
        trows, tattrs, grid, yb, _ = R.peel_inputs(sim.scene, cfg, W, H, state)
        prep = R.prepare(sim.scene, cfg, W, H, state)
        rows16 = pack_triangle_rows(prep["e"], prep["det"], prep["vz"], prep["vs"])
        del prep
        for name, fn in (
                ("peel_resolve", lambda: peel_resolve(trows, tattrs, grid, yb, K, **b3_kw)),
                ("depth_peel", lambda: depth_peel(rows16, grid, K, **b9_kw))):
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize()
            r = dict(label=args.label, shape=shape, kernel=name,
                     rows=list(trows.shape if name == "peel_resolve" else rows16.shape),
                     P=grid.shape[1], K=K, ms=ms(fn, 10, 1), ms_b2b=ms(fn, 5, 5),
                     sha256=digest(*out), card=card)
            del out
            rows.append(r)
            print(f"[peelbench] {args.label} {shape} {name} rows {tuple(r['rows'])}"
                  f" P={r['P']} K={K}: {r['ms']:.4f} ms single, {r['ms_b2b']:.4f} ms"
                  f" back to back; output sha256 {r['sha256']}; {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"peelbench_{args.label}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
