from .level_bank import LevelBank

__all__ = ["LevelBank"]
