"""launches_per_update: the kernels the device ran in the profiled window
over the workers' updates completed there (a count)."""


def read(ctx):
    t, u = ctx.trace, ctx.trace_window.get("units")
    if t is None or not t.n_kernels or not u:
        return None
    return t.n_kernels / u
