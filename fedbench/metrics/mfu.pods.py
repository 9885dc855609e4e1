"""mfu.pods: PaLM's model FLOP of the tokens the pods trained over the plain
window (6 N + 12 L S d a token, no recomputation), as a share of one
H100's bf16 peak."""
from fedbench import yardstick


def read(ctx):
    w = ctx.window
    if not w["units"]:
        return None
    return yardstick.utilization(w["units"] * ctx.facts["flops_per_token"],
                                 w["seconds"], yardstick.PEAK_FLOPS["bf16"])
