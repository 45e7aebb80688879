"""Device milliseconds a registration of the kernels, copies and fills
launched under the port's ``tpuslam.entry.fgt`` span: the Fast Gauss
Transform's set-up at a CPD registration's entry: both clouds'
clusterings and the static tables (``regbench/span_time.py``), over the
``tpuslam.register`` spans of the stretch.  None where the trace holds
no such span or no device operation."""

import span_time

LAYER = "FGT"


def read(trace):
    return span_time.device_ms_per_reg(trace, "tpuslam.entry.fgt")
