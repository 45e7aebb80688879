"""Device milliseconds an iteration of kernel P's entries (Procrustes, SVD, error, M-step moments): the profiler's
kernel time of every kernel whose family (``regbench/kernels/*.json``)
names the layer "Procrustes / M-step", over the iterations that the profiled
registrations returned.  None where no such kernel ran."""

LAYER = "Procrustes / M-step"


def read(trace):
    us, count = trace.kernel_us(LAYER)
    its = trace.iterations()
    if count == 0 or its == 0:
        return None
    return us / 1000.0 / its
