"""worker_sgd_ms: the median of the span around each worker's local training
call (``train_fn``), synchronised before and after, in the span window."""
import statistics


def read(ctx):
    s = ctx.spans.get("worker_sgd_s")
    return 1e3 * statistics.median(s) if s else None
