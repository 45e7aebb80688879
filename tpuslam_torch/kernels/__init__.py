"""The hand-written CUDA kernels K1-K5, K5's plan, P and the FGT's K6 and
K7, each behind a
wrapper that keeps its plain PyTorch version beside it.

Every wrapper adds one to its module's counter where it launches its
kernel and nowhere else (a launch recorded into a CUDA graph is not yet
a launch); ``launch_counts`` reads all of them under one set of names,
``launch_delta`` subtracts an earlier reading.

The kernels that the device-resident ICP and CPD loops run (K1, K2, K3,
K4's and K5's passes, K5's plan, P's entries, K6 and K7) also count
themselves on the device,
in ``tally(device)``: each launch adds one to its kernel's row, and a
predicated launch that did no work (an unselected arm of the
hierarchical search, an unselected route of the CPD E-step, a fat-block
pass with no fat block) adds one to its second column as it returns.  A
replayed CUDA graph runs no wrapper, so the loops book each replay's
launches from the tally (``book_replay``), and ``launch_counts`` reads
the launches that did no work as ``SKIPPED``.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import Optional

import torch

KERNELS = ("K1", "K2", "K3", "K4_denom", "K4_moments", "K5_denom", "K5_moments", "P",
           "K5_plan", "K6", "K7")
# P's entries, counted apart as well as in "P"
P_ENTRIES = ("P procrustes", "P svd", "P error", "P moments")
# the kernels that count themselves on the device (rows of the tally), each
# with its wrapper module and that module's counter
TALLIED = {
    "K1": ("nn_dense", "LAUNCHES"),
    "K2": ("bound", "LAUNCHES"),
    "K3": ("nn_cand", "LAUNCHES"),
    "K4_denom": ("cpd_dense", "DENOM_LAUNCHES"),
    "K4_moments": ("cpd_dense", "MOMENTS_LAUNCHES"),
    "K5_denom": ("cpd_cand", "DENOM_LAUNCHES"),
    "K5_moments": ("cpd_cand", "MOMENTS_LAUNCHES"),
    **{name: ("procrustes", "LAUNCHES") for name in P_ENTRIES},
    "K5_plan": ("cpd_cand", "PLAN_LAUNCHES"),
    "K6": ("fgt", "PREDICT_LAUNCHES"),
    "K7": ("fgt", "EXPAND_LAUNCHES"),
}
# the predicated kernels: their launches that returned at once
SKIPPED = ("K1 skipped", "K3 skipped", "K4_denom skipped", "K4_moments skipped",
           "K5_denom skipped", "K5_moments skipped")

# device index -> i32[len(TALLIED), 2] (launches run, launches skipped)
_TALLIES: dict = {}
# device index -> i32[ARRIVALS] (P's last-block counters, each left at 0)
_ARRIVALS: dict = {}
ARRIVALS = 65536  # P's batch bound (its grid's y extent) and then some
# the launches recorded into the CUDA graph being captured, by (wrapper
# module, batch size), while ``recording_capture`` is open
_CAPTURED: Optional[Counter] = None


def _modules() -> dict:
    from tpuslam_torch.kernels import (bound, cpd_cand, cpd_dense, fgt, nn_cand, nn_dense,
                                       procrustes)

    return {"nn_dense": nn_dense, "bound": bound, "nn_cand": nn_cand, "cpd_dense": cpd_dense,
            "cpd_cand": cpd_cand, "procrustes": procrustes, "fgt": fgt}


def _persistent(store: dict, device, rows, what: str) -> Optional[torch.Tensor]:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in store:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the {what} must exist before a CUDA graph is captured")
        store[index] = torch.zeros(rows, dtype=torch.int32,
                                   device=torch.device("cuda", index))
    return store[index]


def tally(device) -> Optional[torch.Tensor]:
    """The launch tally on ``device``: i32[len(TALLIED), 2], a row for each
    kernel of ``TALLIED`` in order (launches run, predicated launches that
    did no work), made once and kept at its address, as CUDA graphs record
    it; None on the CPU."""
    return _persistent(_TALLIES, device, (len(TALLIED), 2), "launch tally")


def tally_ptr(name: str, device) -> int:
    """The address of kernel ``name``'s row of the tally on ``device``."""
    t = tally(device)
    return t[list(TALLIED).index(name)].data_ptr()


def arrivals_ptr(device) -> int:
    """The address of P's arrival counters on ``device`` (i32[ARRIVALS],
    all 0 between launches: the block that finishes a pair last resets
    its counter), made once, as the tally."""
    return _persistent(_ARRIVALS, device, (ARRIVALS,), "arrival counters").data_ptr()


def counting() -> bool:
    """False while the current stream is being captured into a CUDA
    graph: a wrapper counts a launch only when it launches."""
    return not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def counted(module: str, batch: int) -> bool:
    """Whether the wrapper of ``module`` counts the launch it just made
    (``counting``); while a graph is captured inside
    ``recording_capture``, the launch's batch size is recorded for the
    graph's replays instead."""
    if counting():
        return True
    if _CAPTURED is not None:
        _CAPTURED[(module, batch)] += 1
    return False


@contextmanager
def recording_capture():
    """Within the block, the launches recorded into a CUDA graph are
    counted by (wrapper module, batch size) in the returned Counter: the
    batch sizes of a replay's launches (its launches themselves are read
    from the tally)."""
    global _CAPTURED
    prev, _CAPTURED = _CAPTURED, Counter()
    try:
        yield _CAPTURED
    finally:
        _CAPTURED = prev


def book_replay(delta: list, captured: Counter) -> None:
    """Add a replayed graph's launches, as the device's tally recorded
    them (``delta``: each ``TALLIED`` kernel's launches run, in order), to
    the wrappers' counters, and the batch sizes its capture recorded
    (``captured``) to their ``BATCH_LAUNCHES``."""
    mods = _modules()
    for (name, (module, counter)), n in zip(TALLIED.items(), delta):
        if n:
            mod = mods[module]
            setattr(mod, counter, getattr(mod, counter) + n)
            if name in P_ENTRIES:
                mod.ENTRY_LAUNCHES[name] += n
    for (module, batch), n in captured.items():
        batches = getattr(mods[module], "BATCH_LAUNCHES", None)
        if batches is not None:
            batches[batch] += n


def launch_counts() -> dict:
    """Each kernel's launches so far in this process, by its name in
    ``KERNELS`` and ``P_ENTRIES``, and the predicated launches that did no
    work (``SKIPPED``, read from the devices' tallies)."""
    from tpuslam_torch.kernels import (bound, cpd_cand, cpd_dense, fgt, nn_cand, nn_dense,
                                       procrustes)

    counts = dict(zip(KERNELS, (
        nn_dense.LAUNCHES, bound.LAUNCHES, nn_cand.LAUNCHES, cpd_dense.DENOM_LAUNCHES,
        cpd_dense.MOMENTS_LAUNCHES, cpd_cand.DENOM_LAUNCHES, cpd_cand.MOMENTS_LAUNCHES,
        procrustes.LAUNCHES, cpd_cand.PLAN_LAUNCHES, fgt.PREDICT_LAUNCHES,
        fgt.EXPAND_LAUNCHES)))
    counts.update((name, procrustes.ENTRY_LAUNCHES[name]) for name in P_ENTRIES)
    skipped = dict.fromkeys(SKIPPED, 0)
    for t in _TALLIES.values():
        col = dict(zip(TALLIED, t[:, 1].tolist()))
        for name in SKIPPED:
            skipped[name] += col[name.removesuffix(" skipped")]
    counts.update(skipped)
    return counts


def launch_delta(before: dict) -> dict:
    """The launches since ``before`` (a ``launch_counts()`` reading)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def reset_launch_counts() -> None:
    from tpuslam_torch.kernels import (bound, cpd_cand, cpd_dense, fgt, nn_cand, nn_dense,
                                       procrustes)

    nn_dense.LAUNCHES = bound.LAUNCHES = nn_cand.LAUNCHES = procrustes.LAUNCHES = 0
    fgt.PREDICT_LAUNCHES = fgt.EXPAND_LAUNCHES = 0
    procrustes.ENTRY_LAUNCHES.clear()
    cpd_dense.DENOM_LAUNCHES = cpd_dense.MOMENTS_LAUNCHES = 0
    cpd_cand.DENOM_LAUNCHES = cpd_cand.MOMENTS_LAUNCHES = cpd_cand.PLAN_LAUNCHES = 0
    for t in _TALLIES.values():
        t.zero_()
