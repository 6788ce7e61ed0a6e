"""step_ms (layer: step): ms per tic of the public step alone, replayed on
the card (`DoomSim.step_n`, or `LevelBank.step_with_exits` captured as a
`graphs.CapturedTick`), host clock ending in a synchronize, over at least
STEP_SECONDS; taken after the timed window, in the traced run."""


def read(ctx):
    return ctx.program.time_step(ctx.step_index, ctx.step_seconds)
