"""From-scratch TrueType font parser + rasterizer (host-side).

Reference capability: engine/src/text.rs:281-284 renders the debug/help
overlay with rusttype at 24pt from assets/ttf/OpenSans-Regular.ttf. This
module reproduces that capability without font dependencies: it parses
the sfnt tables directly (head/cmap/loca/glyf/hhea/hmtx, composite
glyphs included) and rasterizes antialiased coverage with the
signed-area accumulation technique (per line segment, accumulate
d(coverage)/dx into a (H, W+1) buffer, then prefix-sum along x --
exact analytic coverage for non-overlapping contours, no supersampling).

The shipped OpenSans-Regular.ttf is an Apache-2.0 licensed DATA asset
(license alongside), the same file the reference uses.

A copy of the JAX package's `utils/ttf.py` (numpy only; the port imports
nothing of that package).
"""

from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np

ON_CURVE = 1
X_SHORT = 2
Y_SHORT = 4
REPEAT = 8
X_SAME_OR_POS = 16
Y_SAME_OR_POS = 32

# Composite glyph component flags.
ARG_1_AND_2_ARE_WORDS = 0x0001
ARGS_ARE_XY_VALUES = 0x0002
WE_HAVE_A_SCALE = 0x0008
MORE_COMPONENTS = 0x0020
WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
WE_HAVE_A_TWO_BY_TWO = 0x0080


class TtfFont:
    """Minimal TrueType reader: codepoint -> scaled outline -> coverage
    bitmap. Enough for the ASCII/Latin-1 debug overlay the reference
    draws (text.rs); not a full OpenType implementation."""

    def __init__(self, data: bytes):
        self.data = data
        self.tables = self._parse_directory()
        (
            self.units_per_em,
            self.index_to_loc_long,
        ) = self._parse_head()
        self.num_glyphs = self._parse_maxp()
        self.cmap = self._parse_cmap()
        self.loca = self._parse_loca()
        self.advances = self._parse_hmtx()
        self.ascent, self.descent, self.line_gap = self._parse_hhea()[:3]

    @classmethod
    def open(cls, path: str) -> "TtfFont":
        with open(path, "rb") as f:
            return cls(f.read())

    # -- table parsing ----------------------------------------------------

    def _parse_directory(self):
        num_tables = struct.unpack_from(">H", self.data, 4)[0]
        tables = {}
        for i in range(num_tables):
            tag, _, off, length = struct.unpack_from(
                ">4sIII", self.data, 12 + 16 * i
            )
            tables[tag.decode("latin-1")] = (off, length)
        return tables

    def _parse_head(self):
        off = self.tables["head"][0]
        units_per_em = struct.unpack_from(">H", self.data, off + 18)[0]
        loc_fmt = struct.unpack_from(">h", self.data, off + 50)[0]
        return units_per_em, loc_fmt == 1

    def _parse_maxp(self):
        off = self.tables["maxp"][0]
        return struct.unpack_from(">H", self.data, off + 4)[0]

    def _parse_hhea(self):
        off = self.tables["hhea"][0]
        ascent, descent, line_gap = struct.unpack_from(
            ">hhh", self.data, off + 4
        )
        num_hmetrics = struct.unpack_from(">H", self.data, off + 34)[0]
        return ascent, descent, line_gap, num_hmetrics

    def _parse_hmtx(self):
        n = self._parse_hhea()[3]
        off = self.tables["hmtx"][0]
        adv = np.zeros(self.num_glyphs, np.int32)
        last = 0
        for i in range(min(n, self.num_glyphs)):
            last = struct.unpack_from(">H", self.data, off + 4 * i)[0]
            adv[i] = last
        adv[n:] = last  # monospace tail
        return adv

    def _parse_cmap(self):
        """Unicode BMP mapping from a format-4 subtable."""
        off = self.tables["cmap"][0]
        n = struct.unpack_from(">H", self.data, off + 2)[0]
        best = None
        for i in range(n):
            pid, eid, sub_off = struct.unpack_from(
                ">HHI", self.data, off + 4 + 8 * i
            )
            if (pid, eid) in ((3, 1), (0, 3), (0, 4), (3, 10)):
                best = off + sub_off
                if pid == 3 and eid == 1:
                    break
        if best is None:
            raise ValueError("no unicode cmap subtable")
        fmt = struct.unpack_from(">H", self.data, best)[0]
        if fmt != 4:
            raise ValueError(f"unsupported cmap format {fmt}")
        segcount2 = struct.unpack_from(">H", self.data, best + 6)[0]
        sc = segcount2 // 2
        ends = np.frombuffer(self.data, ">u2", sc, best + 14)
        starts = np.frombuffer(self.data, ">u2", sc, best + 16 + segcount2)
        deltas = np.frombuffer(self.data, ">i2", sc, best + 16 + 2 * segcount2)
        range_off_pos = best + 16 + 3 * segcount2
        range_offs = np.frombuffer(self.data, ">u2", sc, range_off_pos)
        mapping = {}
        for i in range(sc):
            for c in range(int(starts[i]), int(ends[i]) + 1):
                if c == 0xFFFF:
                    continue
                if range_offs[i] == 0:
                    g = (c + int(deltas[i])) & 0xFFFF
                else:
                    addr = (
                        range_off_pos + 2 * i + int(range_offs[i])
                        + 2 * (c - int(starts[i]))
                    )
                    g = struct.unpack_from(">H", self.data, addr)[0]
                    if g:
                        g = (g + int(deltas[i])) & 0xFFFF
                if g:
                    mapping[c] = g
        return mapping

    def _parse_loca(self):
        off, _ = self.tables["loca"]
        n = self.num_glyphs + 1
        if self.index_to_loc_long:
            return np.frombuffer(self.data, ">u4", n, off).astype(np.int64)
        return np.frombuffer(self.data, ">u2", n, off).astype(np.int64) * 2

    # -- outlines ---------------------------------------------------------

    def glyph_index(self, ch: str) -> int:
        return self.cmap.get(ord(ch), 0)

    @lru_cache(maxsize=512)
    def glyph_outline(self, gid: int):
        """List of contours; each contour is an (N, 3) f64 array of
        (x, y, on_curve) points in font units (quadratic B-spline)."""
        glyf_off = self.tables["glyf"][0]
        start, end = self.loca[gid], self.loca[gid + 1]
        if end <= start:
            return []
        off = glyf_off + int(start)
        n_contours = struct.unpack_from(">h", self.data, off)[0]
        if n_contours >= 0:
            return self._simple_outline(off, n_contours)
        return self._composite_outline(off + 10)

    def _simple_outline(self, off, n_contours):
        d = self.data
        end_pts = struct.unpack_from(f">{n_contours}H", d, off + 10)
        n_pts = end_pts[-1] + 1
        p = off + 10 + 2 * n_contours
        instr_len = struct.unpack_from(">H", d, p)[0]
        p += 2 + instr_len
        flags = np.zeros(n_pts, np.uint8)
        i = 0
        while i < n_pts:
            f = d[p]
            p += 1
            flags[i] = f
            i += 1
            if f & REPEAT:
                rep = d[p]
                p += 1
                flags[i : i + rep] = f
                i += rep
        xs = np.zeros(n_pts, np.int64)
        x = 0
        for i in range(n_pts):
            f = flags[i]
            if f & X_SHORT:
                dx = d[p]
                p += 1
                x += dx if f & X_SAME_OR_POS else -dx
            elif not f & X_SAME_OR_POS:
                x += struct.unpack_from(">h", d, p)[0]
                p += 2
            xs[i] = x
        ys = np.zeros(n_pts, np.int64)
        y = 0
        for i in range(n_pts):
            f = flags[i]
            if f & Y_SHORT:
                dy = d[p]
                p += 1
                y += dy if f & Y_SAME_OR_POS else -dy
            elif not f & Y_SAME_OR_POS:
                y += struct.unpack_from(">h", d, p)[0]
                p += 2
            ys[i] = y
        contours = []
        s = 0
        for e in end_pts:
            pts = np.stack(
                [
                    xs[s : e + 1].astype(np.float64),
                    ys[s : e + 1].astype(np.float64),
                    (flags[s : e + 1] & ON_CURVE).astype(np.float64),
                ],
                axis=-1,
            )
            contours.append(pts)
            s = e + 1
        return contours

    def _composite_outline(self, p):
        d = self.data
        contours = []
        while True:
            flags, gid = struct.unpack_from(">HH", d, p)
            p += 4
            if flags & ARG_1_AND_2_ARE_WORDS:
                a1, a2 = struct.unpack_from(">hh", d, p)
                p += 4
            else:
                a1, a2 = struct.unpack_from(">bb", d, p)
                p += 2
            xf = np.eye(2)
            if flags & WE_HAVE_A_SCALE:
                s = struct.unpack_from(">h", d, p)[0] / 16384.0
                p += 2
                xf = np.diag([s, s])
            elif flags & WE_HAVE_AN_X_AND_Y_SCALE:
                sx, sy = (
                    v / 16384.0 for v in struct.unpack_from(">hh", d, p)
                )
                p += 4
                xf = np.diag([sx, sy])
            elif flags & WE_HAVE_A_TWO_BY_TWO:
                m = [v / 16384.0 for v in struct.unpack_from(">hhhh", d, p)]
                p += 8
                xf = np.array([[m[0], m[1]], [m[2], m[3]]])
            dx, dy = (a1, a2) if flags & ARGS_ARE_XY_VALUES else (0, 0)
            for c in self.glyph_outline(gid):
                c = c.copy()
                c[:, :2] = c[:, :2] @ xf.T + np.array([dx, dy])
                contours.append(c)
            if not flags & MORE_COMPONENTS:
                break
        return contours

    # -- rasterization ----------------------------------------------------

    def rasterize(self, ch: str, size_px: float):
        """(coverage (h, w) f32 in [0,1], (x_offset, y_offset from
        baseline-top, advance_px)). Empty glyphs give a (0, 0) bitmap."""
        gid = self.glyph_index(ch)
        scale = size_px / self.units_per_em
        adv = float(self.advances[gid]) * scale
        segs = []
        for contour in self.glyph_outline(gid):
            segs.extend(_contour_segments(contour))
        if not segs:
            return np.zeros((0, 0), np.float32), (0.0, 0.0, adv)
        pts = np.concatenate([s.reshape(-1, 2) for s in segs])
        pts = pts * scale
        x0 = np.floor(pts[:, 0].min())
        x1 = np.ceil(pts[:, 0].max())
        y1 = np.ceil(pts[:, 1].max())
        y0 = np.floor(pts[:, 1].min())
        w = max(int(x1 - x0), 1)
        h = max(int(y1 - y0), 1)
        acc = np.zeros((h, w + 1), np.float64)
        for seg in segs:
            a = seg[0] * scale - (x0, y0)
            b = seg[1] * scale - (x0, y0)
            _accumulate(acc, a[0], a[1], b[0], b[1])
        cov = np.abs(np.cumsum(acc[:, :-1], axis=1))
        cov = np.minimum(cov, 1.0).astype(np.float32)[::-1]  # y-up -> rows
        return cov, (float(x0), float(y1), adv)


def _contour_segments(contour, tol_steps: int = 8):
    """Quadratic-spline contour -> line segments (each (2, 2) array).
    Implied on-curve midpoints between consecutive off-curve points, as
    per the TrueType spec."""
    pts = contour[:, :2]
    on = contour[:, 2] > 0.5
    n = len(pts)
    if n == 0:
        return []
    # Build expanded point list starting at an on-curve point.
    expanded = []  # (point, is_on)
    start = int(np.argmax(on)) if on.any() else 0
    order = list(range(start, n)) + list(range(start))
    if not on.any():
        expanded.append(((pts[order[0]] + pts[order[-1]]) / 2.0, True))
    for i in order:
        expanded.append((pts[i], bool(on[i])))
    # Insert implied midpoints.
    full = []
    m = len(expanded)
    for i in range(m):
        p, o = expanded[i]
        full.append((p, o))
        q, oq = expanded[(i + 1) % m]
        if not o and not oq:
            full.append(((p + q) / 2.0, True))
    # Walk: on -> [off ->] on.
    segs = []
    m = len(full)
    i = 0
    # rotate so full[0] is on-curve
    while not full[i % m][1]:
        i += 1
    startpt = full[i % m][0]
    cur = startpt
    j = i + 1
    steps = 0
    while steps < m:
        p, o = full[j % m]
        if o:
            segs.append(np.array([cur, p]))
            cur = p
            j += 1
            steps += 1
        else:
            ctrl = p
            nxt = full[(j + 1) % m][0]
            t = np.linspace(0.0, 1.0, tol_steps + 1)[:, None]
            bez = (
                (1 - t) ** 2 * cur + 2 * (1 - t) * t * ctrl + t**2 * nxt
            )
            for k in range(tol_steps):
                segs.append(np.array([bez[k], bez[k + 1]]))
            cur = nxt
            j += 2
            steps += 2
    return segs


def _accumulate(acc, x0, y0, x1, y1):
    """font-rs style signed-area accumulation of one line segment into a
    (h, w+1) buffer (y measured upward; rows indexed by y)."""
    if y0 == y1:
        return
    direction = 1.0
    if y0 > y1:
        x0, y0, x1, y1 = x1, y1, x0, y0
        direction = -1.0
    h, w1 = acc.shape
    dxdy = (x1 - x0) / (y1 - y0)
    y = max(y0, 0.0)
    y_end = min(y1, float(h))
    while y < y_end:
        row = int(y)
        row_top = min(float(row + 1), y_end)
        dy = row_top - y
        xa = x0 + (y - y0) * dxdy
        xb = x0 + (row_top - y0) * dxdy
        if xb < xa:
            xa, xb = xb, xa
        xa = min(max(xa, 0.0), w1 - 1.0)
        xb = min(max(xb, 0.0), w1 - 1.0)
        ca = int(xa)
        cb = int(xb)
        if ca == cb:
            # Whole slice inside one pixel column: split coverage
            # between this column and the next by the midpoint rule.
            mid = (xa + xb) / 2.0
            frac = 1.0 - (mid - ca)
            acc[row, ca] += direction * dy * frac
            acc[row, ca + 1] += direction * dy * (1.0 - frac)
        else:
            # Distribute across spanned columns proportionally to the
            # horizontal overlap (trapezoid areas).
            inv = 1.0 / (xb - xa)
            for c in range(ca, cb + 1):
                lo = max(xa, float(c))
                hi = min(xb, float(c + 1))
                if hi <= lo:
                    continue
                part = (hi - lo) * inv  # fraction of dy in this column
                mid = (lo + hi) / 2.0
                frac = 1.0 - (mid - c)
                acc[row, c] += direction * dy * part * frac
                if c + 1 < w1:
                    acc[row, c + 1] += direction * dy * part * (1.0 - frac)
        y = row_top


_DEFAULT = None


def default_font():
    """The shipped OpenSans face (ref text.rs:281), or None if absent."""
    global _DEFAULT
    if _DEFAULT is None:
        import os

        path = os.path.join(
            os.path.dirname(__file__), "..", "..", "assets", "ttf",
            "OpenSans-Regular.ttf",
        )
        _DEFAULT = TtfFont.open(path) if os.path.exists(path) else False
    return _DEFAULT or None


def draw_ttf_text(img: np.ndarray, xy, text: str, size_px: float = 24.0,
                  color=(255, 255, 255), font: TtfFont | None = None):
    """Alpha-blend TTF text onto an (H, W, 3) uint8 image at xy (the
    BASELINE origin of the first glyph), mirroring the reference's
    alpha-blended overlay pass (text.rs:99-118; 24pt default
    text.rs:283)."""
    font = font or default_font()
    if font is None:
        from .text import draw_text  # bitmap fallback

        return draw_text(img, text, int(xy[0]), int(xy[1]), color)
    x_pen, y_base = float(xy[0]), float(xy[1])
    h_img, w_img = img.shape[:2]
    color = np.asarray(color, np.float32)
    for ch in text:
        if ch == " ":
            x_pen += font.advances[font.glyph_index(" ")] * (
                size_px / font.units_per_em
            )
            continue
        cov, (gx, gy_top, adv) = font.rasterize(ch, size_px)
        gh, gw = cov.shape
        if gh and gw:
            y0 = int(round(y_base - gy_top))
            x0 = int(round(x_pen + gx))
            ys = slice(max(y0, 0), min(y0 + gh, h_img))
            xs = slice(max(x0, 0), min(x0 + gw, w_img))
            if ys.stop > ys.start and xs.stop > xs.start:
                cy = slice(ys.start - y0, ys.stop - y0)
                cx = slice(xs.start - x0, xs.stop - x0)
                a = cov[cy, cx][..., None]
                img[ys, xs] = (
                    img[ys, xs] * (1.0 - a) + color * a
                ).astype(np.uint8)
        x_pen += adv
    return img
