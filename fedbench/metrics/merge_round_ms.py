"""merge_round_ms: the median of the span around each merge (``fl_round`` or
``fl_round_delta_compressed``, unpacking included), synchronised before
and after, in the span window."""
import statistics


def read(ctx):
    s = ctx.spans.get("merge_round_s")
    return 1e3 * statistics.median(s) if s else None
