"""b2_roofline (layer: portal raster): the share of its roofline that B2
(render_portal_kernel, the fused classify + shade) reaches: its least time
over its device time in the traced window.

Its least time per rendered frame of the batch, from the cell's shapes:
the larger of its bytes over the card's bandwidth and its f32 operations
over the card's f32 rate (`harness/peaks.py`). Bytes: the frames it
writes, once (palette index u8 and covered bool, 2 bytes a pixel), and
what each column has to read at the least: one record's span and the 11
channels its pixels shade from (13 f32; a column that no record covers
reads every record's span, which is more). Operations: SHADE_PIXEL_OPS
per pixel (its texel address and light row). Left out, since what they
come to depends on the view: the further records a column reads before
its rows are all won, the alpha words and the texels.
"""

from harness.peaks import least_seconds

KERNEL = "render_portal_kernel"
PIXEL_BYTES = 2
COLUMN_BYTES = 13 * 4
SHADE_PIXEL_OPS = 60


def counts(envs: int, width: int, height: int) -> tuple[float, float]:
    """(bytes, f32 operations) of B2 for one frame of `envs` envs."""
    pixels = envs * width * height
    return float(pixels * PIXEL_BYTES + envs * width * COLUMN_BYTES), float(pixels * SHADE_PIXEL_OPS)


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    seconds = ctx.trace.op_seconds(KERNEL)
    if seconds <= 0:
        return None
    least = least_seconds(*counts(ctx.envs, int(ctx.config["width"]),
                                  int(ctx.config["height"])))
    return 100.0 * least * ctx.traced_steps / seconds
