"""Device milliseconds a registration of the kernels, copies and fills
launched under the port's ``tpuslam.loop.trunc`` span: Hybrid's slow
phase where the fast one ran the FGT: K5's plan, K5 or K4 on the
truncated exact E-steps, the M-step and the bookkeeping
(``regbench/span_time.py``), over the ``tpuslam.register`` spans of the
stretch.  None where the trace holds no such span or no device
operation."""

import span_time

LAYER = "device loop"


def read(trace):
    return span_time.device_ms_per_reg(trace, "tpuslam.loop.trunc")
