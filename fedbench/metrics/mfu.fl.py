"""mfu.fl: the benchmark's model FLOP of the workers' local training (the
CNN's forward and backward from its shapes, evaluation left out) over the
plain window, as a share of one H100's float32 peak (the port keeps TF32
off)."""
from fedbench import yardstick


def read(ctx):
    w = ctx.window
    if not w["units"]:
        return None
    return yardstick.utilization(w["units"] * ctx.facts["flops_per_update"],
                                 w["seconds"], yardstick.PEAK_FLOPS["f32"])
