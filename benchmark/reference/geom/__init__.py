"""Level geometry compiler: runs once per level at load time (host-side),
turning WAD tables into the dense arrays the device consumes.

Reference: rust-doom's wad/src/visitor.rs (LevelWalker/LevelAnalysis)
plus the two visitors in game/src/level.rs (render geometry) and
game/src/world.rs (collision geometry).
"""

from .analysis import LevelAnalysis, Trigger, MoveEffect
from .walker import LevelVisitor, LevelWalker, chain_visitors
from .builder import compile_level, LevelArrays

__all__ = [
    "LevelAnalysis",
    "Trigger",
    "MoveEffect",
    "LevelVisitor",
    "LevelWalker",
    "chain_visitors",
    "compile_level",
    "LevelArrays",
]
