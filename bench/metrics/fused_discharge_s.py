"""Device seconds of the fused discharge (k push-relabel cycles a launch)
in the traced request, from the trace.  A time, not a roofline share:
what a launch has to move depends on the state it is handed."""
from bench.lib import readers

#: the parts of the kernel's device symbol
SYMBOL = ("fused_discharge_kernel",)


def read(ctx):
    return readers.device_seconds(ctx, "fused_discharge_s")
