"""Per-tick game systems over a written-out env batch (port of
`tpu_doom.sim`)."""

from .scene import Scene, scene_from_arrays
from .state import (
    Actions,
    SimState,
    actions_from_numpy,
    initial_state,
    null_actions,
    state_from_numpy,
    state_to_numpy,
)
from .step import step

__all__ = [
    "Scene",
    "scene_from_arrays",
    "SimState",
    "Actions",
    "initial_state",
    "null_actions",
    "state_from_numpy",
    "state_to_numpy",
    "actions_from_numpy",
    "step",
]
