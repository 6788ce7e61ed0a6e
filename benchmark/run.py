"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for. Prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error). Exits non-zero, printing no
result, without enough CUDA cards, on any error, or if a module of JAX
or of the JAX package was loaded. `--control bfloat16` also judges the
plain reference computed with its state in bfloat16 (the control of the
check) and reports its readings under `control`.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Build and kernel caches at fixed paths inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "benchmark", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "benchmark", "triton")
sys.path[:0] = [BENCH, ROOT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bfloat16",), default=None)
    args = ap.parse_args(argv)

    import torch

    from harness.cell import Cell, run_cell

    chips = Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start=T_START, control=args.control,
                      log=lambda line: print(line, file=sys.stderr, flush=True))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
