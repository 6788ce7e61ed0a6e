"""Terminal viewer: interactive play in any ANSI terminal.

The reference opens a GL window with glutin (engine/src/window.rs +
context.rs event loop); this environment has no display, so the viewer
renders to the terminal instead: each character cell shows two vertical
pixels via the upper-half-block glyph with 24-bit foreground/background
colors. Input uses raw-mode stdin mapped through the reference's gesture
bindings (utils/input.py); WASD+arrows move/look, E pushes, F fly,
C noclip, H help, N/P change level, Q/Esc quits. A copy of the JAX
package's `utils/viewer.py` on the port's `DoomSim`: each tick steps
eagerly (`sim.step`) with actions built on the host, on the sim's device.
"""

from __future__ import annotations

import select
import sys
import time

import numpy as np

from .input import Bindings, InputState, poll_actions
from .text import draw_hud
from .timers import FrameTimers

# Keys that auto-release after one tick (no key-up events in a terminal).
_HOLD_TICKS = 4


def frame_to_ansi(rgb: np.ndarray) -> str:
    """(H, W, 3) u8 -> ANSI string using half-block cells (2 rows/cell)."""
    h, w, _ = rgb.shape
    if h % 2:
        rgb = rgb[:-1]
        h -= 1
    top = rgb[0::2]
    bot = rgb[1::2]
    lines = []
    for r in range(h // 2):
        parts = []
        prev = None
        for c in range(w):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            key = (tr, tg, tb, br, bg, bb)
            if key != prev:
                parts.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m"
                )
                prev = key
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


def parse_sgr_mouse(seq: str):
    """Parse an xterm SGR mouse report body 'b;x;yM' / 'b;x;ym' (after the
    ESC[< prefix) -> (button, x, y, pressed) or None. A report with the
    motion bit (32) set is pure movement (button = None)."""
    if not seq or seq[-1] not in "Mm":
        return None
    pressed = seq[-1] == "M"
    try:
        b, x, y = (int(v) for v in seq[:-1].split(";"))
    except ValueError:
        return None
    if b & 32:  # motion
        return (None, x, y, pressed)
    return (b & 3, x, y, pressed)


class _RawTerminal:
    """Raw-mode stdin + xterm any-motion mouse reporting (SGR encoding):
    the terminal stand-in for the reference's grabbed-mouse GL window
    (engine/src/window.rs:59-86 + input.rs:232-246)."""

    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        # Hide cursor, clear, enable any-motion mouse tracking + SGR mode.
        sys.stdout.write("\x1b[?25l\x1b[2J\x1b[?1003h\x1b[?1006h")
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)
        sys.stdout.write("\x1b[?1003l\x1b[?1006l\x1b[?25h\x1b[0m\n")

    def _read_csi(self) -> str:
        """Read the body of an ESC[ sequence up to its final byte."""
        body = ""
        while select.select([sys.stdin], [], [], 0.01)[0]:
            ch = sys.stdin.read(1)
            body += ch
            if ch.isalpha() or ch == "~":
                break
        return body

    def read_events(self):
        """-> (keys, mouse_events); mouse events are parse_sgr_mouse
        tuples."""
        keys = []
        mouse = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch != "\x1b":
                keys.append(ch.lower())
                continue
            if not select.select([sys.stdin], [], [], 0.01)[0]:
                keys.append("escape")
                continue
            ch2 = sys.stdin.read(1)
            if ch2 != "[":
                keys.append("escape")
                continue
            body = self._read_csi()
            if body.startswith("<"):
                ev = parse_sgr_mouse(body[1:])
                if ev is not None:
                    mouse.append(ev)
                continue
            keys.append(
                {"A": "up", "B": "down", "C": "right", "D": "left"}.get(
                    body[-1:], "escape"
                )
            )
        return keys, mouse


def play(sim, fps: float = 15.0, width: int = 120, height: int = 80):
    """Interactive terminal session on env 0 of a fresh single-env state."""
    bindings = Bindings()
    inp = InputState()
    state = sim.reset(1)
    timers = FrameTimers()
    show_help = True
    held: dict[str, int] = {}
    ticks_per_frame = max(int(round(1.0 / (fps * sim.config.timestep))), 1)

    # Mouse-look scaling: terminal cells are coarse (1 cell ~ several
    # pixels of the reference's grabbed mouse), so scale deltas up.
    MOUSE_CELL_SCALE = 8.0
    last_mouse: list = [None]

    with _RawTerminal() as term:
        t_next = time.perf_counter()
        while True:
            keys, mouse_events = term.read_events()
            for button, mx, my, pressed in mouse_events:
                if button is None or pressed:
                    if last_mouse[0] is not None:
                        dx = (mx - last_mouse[0][0]) * MOUSE_CELL_SCALE
                        dy = (my - last_mouse[0][1]) * MOUSE_CELL_SCALE
                        inp.mouse_motion(dx, dy)
                    last_mouse[0] = (mx, my)
                if button is not None:
                    if pressed:
                        inp.button_down(button)
                    else:
                        inp.button_up(button)
            for key in keys:
                if key in ("q",):
                    return
                if key == "escape":
                    return
                if key == "h":
                    show_help = not show_help
                    continue
                if key == "n":
                    sim.load_level(sim.level_index + 1)
                    state = sim.reset(1)
                    continue
                if key == "p":
                    sim.load_level(sim.level_index - 1)
                    state = sim.reset(1)
                    continue
                held[key] = _HOLD_TICKS
                inp.key_down(key)

            with timers.time("tick"):
                for _ in range(ticks_per_frame):
                    actions = poll_actions(inp, bindings, batch=1, device=sim.device)
                    state = sim.step(state, actions)
                    inp.advance()
                    for k in list(held):
                        held[k] -= 1
                        if held[k] <= 0:
                            inp.key_up(k)
                            del held[k]

            with timers.time("frame"):
                rgb = sim.render_rgb(state, width, height)[0]
            name = sim.arrays.name.rstrip(b"\0").decode("ascii", "replace")
            t = timers.timers.get("frame")
            fps_now = (
                t.times_since_logged / max(t.seconds_since_logged, 1e-9)
                if t and t.times_since_logged
                else 0.0
            )
            draw_hud(rgb, level_name=name, fps=fps_now, show_help=show_help)
            sys.stdout.write("\x1b[H" + frame_to_ansi(rgb))
            sys.stdout.flush()
            timers.maybe_log()

            t_next += 1.0 / fps
            delay = t_next - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            else:
                t_next = time.perf_counter()
