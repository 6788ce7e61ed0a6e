"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (the level compiler `wad/` and `geom/`, the step `sim/`, the
walk and raster `render/` and `ops/`, and the bank `models/level_bank.py`),
with every kernel wrapper reduced to its plain version, so it runs the
same function on any device. It imports nothing of the port, so later
changes to the port do not move the yardstick; `wad/wadgen.py` makes the
synthetic WADs that both sides load.

`levels.compile_levels` compiles (wad, level) specs from the WAD bytes the
benchmark hands to both sides.
"""
