"""Device milliseconds an iteration of the CPD E-step's kernels (K4, K5): the profiler's
kernel time of every kernel whose family (``regbench/kernels/*.json``)
names the layer "CPD E-step", over the iterations that the profiled
registrations returned.  None where no such kernel ran."""

LAYER = "CPD E-step"


def read(trace):
    us, count = trace.kernel_us(LAYER)
    its = trace.iterations()
    if count == 0 or its == 0:
        return None
    return us / 1000.0 / its
