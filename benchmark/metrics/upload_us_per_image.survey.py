"""upload_us_per_image.survey: device time of the host-to-device copies in
the traced window, over the frames dispatched in it."""


def read(ctx):
    s = ctx.summary
    frames = sum(rows for _, _, rows in ctx.win.dispatches)
    if s is None or not frames:
        return None
    up = s.device_s(lambda e: e.kind == "gpu_memcpy" and "HtoD" in e.name)
    return up / frames * 1e6 if up > 0 else None
