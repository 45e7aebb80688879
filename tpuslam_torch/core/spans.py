"""Named spans over the port's stages, on the profiler's clock.

``with span("tpuslam.loop"):`` marks a stage of a registration.  While a
``torch.profiler`` records, the span is a ``record_function`` range: a
``user_annotation`` event in the profiler's trace, on the clock of the
device's kernels and copies, so a reader of the trace can give each
device operation the stage whose span launched it.  While no profiler
records, ``span`` returns one shared context that does nothing: one
boolean query, no allocation, no device call, no synchronisation.  The
spans live in the profiler's trace alone; the port keeps no store of
its own.

The port's spans, each nested in the one above it:

* ``tpuslam.register``: one request, ``registry.run_with_configuration``;
* ``tpuslam.entry.copy_in``: padding and the host-to-device copies;
* ``tpuslam.entry.prepare``: the set-up on the device before the loop
  (ICP's spatial preparation, arm and initial state; CPD's ``_EM`` and
  initial state);
* ``tpuslam.entry.fgt``: inside ``tpuslam.entry.prepare``, the Fast
  Gauss Transform's set-up in CPD's ``_EM``: both clouds' clusterings
  and the static tables;
* ``tpuslam.loop``: ``device_loop.run_chunks``, every chunk, capture,
  replay and status read;
* ``tpuslam.loop.fgt`` and ``tpuslam.loop.trunc``: one chunk of a CPD
  loop that runs the FGT (Full or Hybrid at or above the crossover, or
  with ``use_fgt``), its eager run, capture or replay and its status
  read, named by the chunk's phase (``cpd.PHASES``): the FGT's E-steps
  (Full, Hybrid's fast phase) or the truncated exact ones (Hybrid's
  slow phase).  A chunk whose phase is a device flag, and ICP's, has
  none;
* ``tpuslam.loop.capture``: a chunk captured as a CUDA graph (inside a
  phase span where the chunk has one);
* ``tpuslam.entry.read_out``: the result's device-to-host read.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch
from torch.profiler import record_function

_OFF = nullcontext()


def span(name: Optional[str]):
    """A context over the stage ``name``: a ``record_function`` range while
    a profiler records, else (or where ``name`` is None) a shared no-op."""
    if name is None or not torch._C._autograd._profiler_enabled():
        return _OFF
    return record_function(name)
