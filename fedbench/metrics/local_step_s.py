"""local_step_s: the median of the span around each ``fl_local_step`` (every
pod's AdamW step), synchronised before and after, in the span window."""
import statistics


def read(ctx):
    s = ctx.spans.get("local_step_s")
    return statistics.median(s) if s else None
