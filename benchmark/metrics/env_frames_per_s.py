"""env_frames_per_s: envs x game tics simulated over the timed window's
wall time (host clock, ending in a synchronize). Every tic is stepped and
every frame_skip-th rendered; skipped frames count, as Sample Factory
counts them."""


def read(ctx):
    return ctx.envs * ctx.tics / ctx.wall_s
