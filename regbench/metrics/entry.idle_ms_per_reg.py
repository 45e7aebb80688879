"""Milliseconds a registration in which the device ran nothing while the
host was inside one of the entry's stages (a ``tpuslam.entry.*`` span of
the port; ``regbench/stages.py``), over the ``tpuslam.register`` spans
of the stretch.  None where the trace holds no such span or no device
operation."""

import stages

LAYER = "entry"


def read(trace):
    regs = stages.registrations(trace)
    if regs == 0 or not trace.device_ops:
        return None
    return stages.idle_us(trace, stages.is_entry) / 1000.0 / regs
