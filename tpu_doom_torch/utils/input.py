"""Input gestures: map key/button event streams to per-tick Actions.

Reference behavior: engine/src/input.rs (Gesture: KeyHold / KeyTrigger /
ButtonHold / ButtonTrigger / AnyOf / AllOf / QuitTrigger; Analog2d:
Mouse / Gestures / Sum) + the default bindings in game/src/player.rs:21-52
and game/src/hud.rs:17-36 (WASD + arrows/mouse look, Space jump, E push,
LMB shoot, F fly, C clip, Esc quit, Ctrl-N/P level change, H help).

This is the host-side half of the action interface: an InputState tracks
pressed keys with update-indexed edge detection (input.rs:86-89,131-134),
and `poll_actions` turns it into the port's Actions tensors each tick. A
copy of the JAX package's `utils/input.py`, whose `poll_actions` builds
JAX arrays; the port imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..sim.state import Actions

# -- gesture algebra (ref input.rs:16-45) -----------------------------------


@dataclass(frozen=True)
class KeyHold:
    key: str


@dataclass(frozen=True)
class KeyTrigger:
    key: str


@dataclass(frozen=True)
class ButtonHold:
    button: int


@dataclass(frozen=True)
class ButtonTrigger:
    button: int


@dataclass(frozen=True)
class AnyOf:
    gestures: tuple


@dataclass(frozen=True)
class AllOf:
    gestures: tuple


@dataclass(frozen=True)
class QuitTrigger:
    pass


Gesture = Union[KeyHold, KeyTrigger, ButtonHold, ButtonTrigger, AnyOf, AllOf, QuitTrigger]


@dataclass(frozen=True)
class MouseAnalog:
    sensitivity: float


@dataclass(frozen=True)
class GesturesAnalog:
    x_positive: Gesture
    x_negative: Gesture
    y_positive: Gesture
    y_negative: Gesture
    step: float


@dataclass(frozen=True)
class SumAnalog:
    analogs: tuple


Analog2d = Union[MouseAnalog, GesturesAnalog, SumAnalog]


@dataclass(frozen=True)
class Bindings:
    """Default bindings (ref player.rs:21-52 + hud.rs:17-36)."""

    movement: Analog2d = GesturesAnalog(
        x_positive=KeyHold("d"),
        x_negative=KeyHold("a"),
        y_positive=KeyHold("s"),
        y_negative=KeyHold("w"),
        step=1.0,
    )
    look: Analog2d = SumAnalog(
        (
            GesturesAnalog(
                x_positive=KeyHold("right"),
                x_negative=KeyHold("left"),
                y_positive=KeyHold("down"),
                y_negative=KeyHold("up"),
                step=0.015,
            ),
            MouseAnalog(sensitivity=0.0015),
        )
    )
    jump: Gesture = KeyHold("space")
    push: Gesture = KeyTrigger("e")
    shoot: Gesture = ButtonTrigger(0)
    fly: Gesture = KeyTrigger("f")
    clip: Gesture = KeyTrigger("c")
    quit: Gesture = AnyOf((QuitTrigger(), KeyTrigger("escape")))
    next_level: Gesture = AllOf((KeyHold("lcontrol"), KeyTrigger("n")))
    previous_level: Gesture = AllOf((KeyHold("lcontrol"), KeyTrigger("p")))
    toggle_help: Gesture = KeyTrigger("h")


class InputState:
    """Pressed-key tracking with update-indexed edge detection
    (ref input.rs:47-134)."""

    def __init__(self):
        self._update_index = 0
        self._keys_down: dict[str, int] = {}  # key -> update index when pressed
        self._buttons_down: dict[int, int] = {}
        self._mouse_rel = np.zeros(2, dtype=np.float64)
        self._quit_requested_index: Optional[int] = None

    # -- event feed -----------------------------------------------------

    def key_down(self, key: str):
        self._keys_down.setdefault(key.lower(), self._update_index)

    def key_up(self, key: str):
        self._keys_down.pop(key.lower(), None)

    def button_down(self, button: int):
        self._buttons_down.setdefault(button, self._update_index)

    def button_up(self, button: int):
        self._buttons_down.pop(button, None)

    def mouse_motion(self, dx: float, dy: float):
        self._mouse_rel += (dx, dy)

    def quit_requested(self):
        self._quit_requested_index = self._update_index

    def advance(self):
        """Call once per tick after polling (ref input.rs reset + index)."""
        self._update_index += 1
        self._mouse_rel[:] = 0.0

    # -- polling (ref input.rs:124-188) ----------------------------------

    def poll_gesture(self, gesture: Gesture) -> bool:
        if isinstance(gesture, KeyHold):
            return gesture.key in self._keys_down
        if isinstance(gesture, KeyTrigger):
            return self._keys_down.get(gesture.key) == self._update_index
        if isinstance(gesture, ButtonHold):
            return gesture.button in self._buttons_down
        if isinstance(gesture, ButtonTrigger):
            return self._buttons_down.get(gesture.button) == self._update_index
        if isinstance(gesture, AnyOf):
            return any(self.poll_gesture(g) for g in gesture.gestures)
        if isinstance(gesture, AllOf):
            return all(self.poll_gesture(g) for g in gesture.gestures)
        if isinstance(gesture, QuitTrigger):
            return self._quit_requested_index == self._update_index
        raise TypeError(gesture)

    def poll_analog2d(self, analog: Analog2d) -> np.ndarray:
        if isinstance(analog, MouseAnalog):
            return self._mouse_rel * analog.sensitivity
        if isinstance(analog, GesturesAnalog):
            x = (1.0 if self.poll_gesture(analog.x_positive) else 0.0) - (
                1.0 if self.poll_gesture(analog.x_negative) else 0.0
            )
            y = (1.0 if self.poll_gesture(analog.y_positive) else 0.0) - (
                1.0 if self.poll_gesture(analog.y_negative) else 0.0
            )
            return np.array([x, y]) * analog.step
        if isinstance(analog, SumAnalog):
            return sum(
                (self.poll_analog2d(a) for a in analog.analogs),
                np.zeros(2),
            )
        raise TypeError(analog)


def poll_actions(input_state: InputState, bindings: Bindings, batch: int = 1,
                 device="cuda"):
    """Poll one env's bindings into Actions tensors on `device` (the card
    unless the caller asks for the CPU), broadcast to `batch` envs. Built
    on the host and copied once per tick: for the interactive viewer, not
    for a captured tick."""
    movement = input_state.poll_analog2d(bindings.movement)
    look = input_state.poll_analog2d(bindings.look)

    def rep2(v):
        return torch.as_tensor(np.tile(np.asarray(v, np.float32)[None, :], (batch, 1)),
                               device=device)

    def repb(flag):
        return torch.full((batch,), bool(flag), device=device)

    return Actions(
        movement=rep2(movement),
        look=rep2(look),
        jump=repb(input_state.poll_gesture(bindings.jump)),
        fly_toggle=repb(input_state.poll_gesture(bindings.fly)),
        clip_toggle=repb(input_state.poll_gesture(bindings.clip)),
        push=repb(input_state.poll_gesture(bindings.push)),
        shoot=repb(input_state.poll_gesture(bindings.shoot)),
    )
