"""Device milliseconds a registration of the kernels, copies and fills
launched under the port's ``tpuslam.loop.fgt`` span: the Fast Gauss
Transform's phase: every chunk of a CPD loop that runs the FGT's E-steps
(Full, Hybrid's fast phase), with its M-step on kernel P and its
bookkeeping (``regbench/span_time.py``), over the ``tpuslam.register``
spans of the stretch.  None where the trace holds no such span or no
device operation."""

import span_time

LAYER = "FGT"


def read(trace):
    return span_time.device_ms_per_reg(trace, "tpuslam.loop.fgt")
