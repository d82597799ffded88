"""images_per_s: frames whose results reached the host inside the window,
over the window's seconds (``loops.closed_loop``)."""


def read(ctx):
    return ctx.win.images_per_s
