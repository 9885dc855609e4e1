"""Kernel ``ef_encode``'s grid form (pass 1, the select, pass 2) against its
byte bound: each encode reads x (f32) once and writes q (int8) and the
residual (f32) once, at 3.35 TB/s, over the three kernels' device time in
the profiled window."""
import re

from fedbench import yardstick

PASSES = re.compile(r"\bef_(pass1|pass2|cluster|reduce)\b")
LAST = re.compile(r"\bef_pass2\b")


def read(ctx):
    encodes, _ = ctx.kernel_seconds(LAST.search)
    _, sec = ctx.kernel_seconds(PASSES.search)
    if not encodes or sec <= 0:
        return None
    return yardstick.roofline_share(
        encodes * yardstick.ef_encode_bytes(ctx.facts["encode_n"]), sec)
