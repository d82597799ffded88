"""v5_c3_ms.survey: device time per detector call of the operations
launched inside the program's ``det:v5:c3`` ranges (``models/yolov5.py``:
each C3 block, its Bottlenecks, their QDQ and epilogues). Nothing is read
from a program without that range."""


def read(ctx):
    s = ctx.summary
    calls = len(ctx.win.dispatches)
    if s is None or not calls:
        return None
    spent = s.device_s(ranges=("det:v5:c3",))
    return spent / calls * 1e3 if spent > 0 else None
