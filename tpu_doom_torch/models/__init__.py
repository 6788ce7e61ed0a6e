"""Top-level simulator API (port of `tpu_doom.models`)."""

from .doom_sim import DoomSim
from .level_bank import LevelBank, pad_level_arrays, stack_portal_scenes

__all__ = ["DoomSim", "LevelBank", "pad_level_arrays", "stack_portal_scenes"]
