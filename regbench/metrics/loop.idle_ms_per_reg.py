"""Milliseconds a registration in which the device ran nothing while the
host was inside the chunk loop (the port's ``tpuslam.loop`` span;
``regbench/stages.py``), over the ``tpuslam.register`` spans of the
stretch.  None where the trace holds no such span or no device
operation."""

import stages

LAYER = "device loop"


def read(trace):
    regs = stages.registrations(trace)
    if regs == 0 or not trace.device_ops:
        return None
    return stages.idle_us(trace, stages.is_loop) / 1000.0 / regs
