"""CUDA graphs captured a registration inside the traced stretch: the
port's ``tpuslam.loop.capture`` spans over its ``tpuslam.register``
spans (``regbench/stages.py``).  None where the trace holds no
``tpuslam.register`` span."""

import stages

LAYER = "device loop"


def read(trace):
    regs = stages.registrations(trace)
    if regs == 0:
        return None
    return sum(1 for _, _, name in stages.spans(trace) if name == stages.CAPTURE) / regs
