"""b2_roofline.<kind>: kernel B2 (``fedavg_agg_flat``, the ``merge`` kernel) against its byte
bound: each launch reads the (W, N) f32 rows and W weights and writes N
f32, at 3.35 TB/s, over B2's device time in the profiled window."""
import re

from fedbench import yardstick

NAME = re.compile(r"\bmerge<")


def read(ctx):
    n, sec = ctx.kernel_seconds(NAME.search)
    if not n or sec <= 0:
        return None
    f = ctx.facts
    return yardstick.roofline_share(n * yardstick.b2_bytes(f["b2_rows"],
                                                           f["b2_n"]), sec)
