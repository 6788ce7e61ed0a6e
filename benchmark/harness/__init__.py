"""The benchmark's harness: one cell of `BENCHMARK.json` per run.

`cell.run_cell` builds the cell's inputs from the seed (`inputs`,
`traffic`), drives the port through the cell's driver
(`benchmark/drivers/<kind>.py`), times the window, reads the per-layer
metrics (`benchmark/metrics/<name>.py`) from a profiler trace
(`trace`), and judges what the window produced against the plain
reference (`check`, `benchmark/reference/`).
"""
