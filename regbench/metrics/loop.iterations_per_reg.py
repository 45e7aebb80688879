"""The mean of the ``iterations`` that ``register`` returned over every
registration of the measured window: the solver's work a request."""

LAYER = "device loop"


def read(trace):
    its = [int(r["iterations"]) for r in trace.window]
    return sum(its) / len(its) if its else None
