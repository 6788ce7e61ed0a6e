"""setup_s: from the start of the process to the first timed agent step:
imports, the WAD files, the level compile and upload, the kernels' build
(the first run in a checkout), the graphs' capture and the warm-up agent
steps."""


def read(ctx):
    return ctx.setup_s
