"""setup_s: seconds from the process's start to the window's: imports and
CUDA, the ACFF library, the engine, the frames, the warm-up."""


def read(ctx):
    return ctx.setup_s
