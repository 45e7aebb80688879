"""Device milliseconds an iteration of the NN search's kernels (K1, K2, K3): the profiler's
kernel time of every kernel whose family (``regbench/kernels/*.json``)
names the layer "NN search", over the iterations that the profiled
registrations returned.  None where no such kernel ran."""

LAYER = "NN search"


def read(trace):
    us, count = trace.kernel_us(LAYER)
    its = trace.iterations()
    if count == 0 or its == 0:
        return None
    return us / 1000.0 / its
