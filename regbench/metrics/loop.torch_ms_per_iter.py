"""Device milliseconds an iteration of the kernels that no family in
``regbench/kernels/`` claims and that the chunk loop launched (the
port's ``tpuslam.loop`` span or a child: eager chunks, captures and
replays; ``regbench/stages.py``), over the iterations that the profiled
registrations returned.  None where the trace holds no
``tpuslam.register`` span or no device operation."""

import stages

LAYER = "device loop"


def read(trace):
    its = trace.iterations()
    if stages.registrations(trace) == 0 or its == 0 or not trace.device_ops:
        return None
    return stages.unclaimed_split(trace)["loop"] / 1000.0 / its
