"""Synchronising calls per registration: every device-to-host read,
blocking copy or waiting library call that torch's CUDA sync debug mode
reports while a few registrations of the traced run go through
``register`` (the chunk reads of the device loop, the entry's copies and
the result's read).  None where nothing was counted."""

LAYER = "device loop"


def read(trace):
    if trace.syncs is None or trace.syncs[1] == 0:
        return None
    count, registrations = trace.syncs
    return count / registrations
