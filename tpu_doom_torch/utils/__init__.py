"""Configuration."""

from .config import GameConfig, PlayerConfig

__all__ = ["GameConfig", "PlayerConfig"]
