"""Device milliseconds a registration of the kernels, copies and fills
that the entry's stages launched (a ``tpuslam.entry.*`` span of the port:
the clouds' padding and copies in, the set-up before the loop, the
result's read; ``regbench/stages.py``), over the ``tpuslam.register``
spans of the stretch.  None where the trace holds no such span or no
device operation."""

import stages

LAYER = "entry"


def read(trace):
    regs = stages.registrations(trace)
    if regs == 0 or not trace.device_ops:
        return None
    us = sum(float(op["dur"]) for op, stage in stages.stage_of_ops(trace)
             if stages.is_entry(stage))
    return us / 1000.0 / regs
