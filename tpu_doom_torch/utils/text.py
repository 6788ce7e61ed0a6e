"""Host-side text overlay + HUD for decoded frames.

Reference: engine/src/text.rs (rusttype TTF debug overlay) and
game/src/hud.rs (help text, quit / level-change / grab-mouse gestures).
The sim itself never needs text; this stamps a built-in 5x7 bitmap font
onto RGB frames after readback (no font/image dependencies exist in this
environment), which fills the same role as the reference's debug overlay.

A copy of the JAX package's `utils/text.py` (numpy only; the port imports
nothing of that package).
"""

from __future__ import annotations

import numpy as np

# 5x7 font for printable ASCII subset; each glyph is 5 columns x 7 rows,
# packed as 7 row-bitmasks (bit 4 = leftmost column).
_FONT = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "!": (4, 4, 4, 4, 4, 0, 4),
    "-": (0, 0, 0, 31, 0, 0, 0),
    ".": (0, 0, 0, 0, 0, 12, 12),
    "/": (1, 2, 2, 4, 8, 8, 16),
    ":": (0, 12, 12, 0, 12, 12, 0),
    "0": (14, 17, 19, 21, 25, 17, 14),
    "1": (4, 12, 4, 4, 4, 4, 14),
    "2": (14, 17, 1, 2, 4, 8, 31),
    "3": (14, 17, 1, 6, 1, 17, 14),
    "4": (2, 6, 10, 18, 31, 2, 2),
    "5": (31, 16, 30, 1, 1, 17, 14),
    "6": (6, 8, 16, 30, 17, 17, 14),
    "7": (31, 1, 2, 4, 8, 8, 8),
    "8": (14, 17, 17, 14, 17, 17, 14),
    "9": (14, 17, 17, 15, 1, 2, 12),
    "A": (14, 17, 17, 31, 17, 17, 17),
    "B": (30, 17, 17, 30, 17, 17, 30),
    "C": (14, 17, 16, 16, 16, 17, 14),
    "D": (30, 17, 17, 17, 17, 17, 30),
    "E": (31, 16, 16, 30, 16, 16, 31),
    "F": (31, 16, 16, 30, 16, 16, 16),
    "G": (14, 17, 16, 23, 17, 17, 14),
    "H": (17, 17, 17, 31, 17, 17, 17),
    "I": (14, 4, 4, 4, 4, 4, 14),
    "J": (7, 2, 2, 2, 2, 18, 12),
    "K": (17, 18, 20, 24, 20, 18, 17),
    "L": (16, 16, 16, 16, 16, 16, 31),
    "M": (17, 27, 21, 21, 17, 17, 17),
    "N": (17, 25, 21, 19, 17, 17, 17),
    "O": (14, 17, 17, 17, 17, 17, 14),
    "P": (30, 17, 17, 30, 16, 16, 16),
    "Q": (14, 17, 17, 17, 21, 18, 13),
    "R": (30, 17, 17, 30, 20, 18, 17),
    "S": (15, 16, 16, 14, 1, 1, 30),
    "T": (31, 4, 4, 4, 4, 4, 4),
    "U": (17, 17, 17, 17, 17, 17, 14),
    "V": (17, 17, 17, 17, 17, 10, 4),
    "W": (17, 17, 17, 21, 21, 27, 17),
    "X": (17, 17, 10, 4, 10, 17, 17),
    "Y": (17, 17, 10, 4, 4, 4, 4),
    "Z": (31, 1, 2, 4, 8, 16, 31),
}


def draw_text(
    rgb: np.ndarray,
    text: str,
    x: int,
    y: int,
    color=(255, 255, 255),
    scale: int = 1,
):
    """Stamp text into an (H, W, 3) u8 frame in place."""
    h, w, _ = rgb.shape
    cx = x
    for ch in text.upper():
        glyph = _FONT.get(ch, _FONT[" "])
        for row, bits in enumerate(glyph):
            for col in range(5):
                if bits & (16 >> col):
                    y0 = y + row * scale
                    x0 = cx + col * scale
                    rgb[
                        max(0, min(h, y0)) : max(0, min(h, y0 + scale)),
                        max(0, min(w, x0)) : max(0, min(w, x0 + scale)),
                    ] = color
        cx += 6 * scale
    return rgb


HELP_TEXT = [
    "WASD: MOVE  ARROWS: LOOK",
    "SPACE: JUMP  E: PUSH",
    "F: FLY  C: NOCLIP",
    "CTRL-N/P: CHANGE LEVEL",
    "ESC: QUIT  H: HELP",
]


def draw_hud(rgb: np.ndarray, *, level_name: str = "", fps: float = 0.0,
             show_help: bool = False, ttf: bool | None = None) -> np.ndarray:
    """Minimal HUD (ref game/src/hud.rs: help overlay + status).

    ttf=None auto-selects the OpenSans TTF overlay (ref text.rs:281-284)
    when the shipped font asset is present, falling back to the built-in
    bitmap font; ttf=False forces the bitmap font."""
    if ttf is None or ttf:
        from .ttf import default_font, draw_ttf_text

        font = default_font()
        if font is not None:
            size = 14.0
            if level_name:
                draw_ttf_text(rgb, (2, 14), level_name, size, font=font)
            if fps:
                draw_ttf_text(
                    rgb, (rgb.shape[1] - 70, 14), f"{fps:5.0f} FPS", size,
                    font=font,
                )
            if show_help:
                for i, line in enumerate(HELP_TEXT):
                    draw_ttf_text(
                        rgb, (2, 30 + int(size * 1.15) * i), line, size,
                        font=font,
                    )
            return rgb
        if ttf:
            raise FileNotFoundError("TTF font asset missing")
    if level_name:
        draw_text(rgb, level_name, 2, 2)
    if fps:
        draw_text(rgb, f"{fps:5.0f} FPS", rgb.shape[1] - 60, 2)
    if show_help:
        for i, line in enumerate(HELP_TEXT):
            draw_text(rgb, line, 2, 14 + 9 * i)
    return rgb
