"""The share of the traced window in which no operation (kernel, copy or
fill) ran on the device, in percent.  None where the trace holds no
device operation."""

LAYER = "device"


def read(trace):
    if not trace.device_ops or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)
