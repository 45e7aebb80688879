"""Device milliseconds an iteration of the kernels that no family in
``regbench/kernels/`` claims: PyTorch's own kernels (the FGT, the NN
front's small kernels, the loop's bookkeeping), over the iterations that
the profiled registrations returned.  None where no such kernel ran."""

LAYER = "torch kernels"


def read(trace):
    us, count = trace.kernel_us(None)
    its = trace.iterations()
    if count == 0 or its == 0:
        return None
    return us / 1000.0 / its
