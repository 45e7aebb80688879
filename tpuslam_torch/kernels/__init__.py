"""The hand-written CUDA kernels K1-K5 and P, each behind a wrapper that
keeps its plain PyTorch version beside it.

Every wrapper adds one to its module's counter where it launches its
kernel and nowhere else (a launch recorded into a CUDA graph is not yet
a launch); ``launch_counts`` reads all of them under one set of names,
``launch_delta`` subtracts an earlier reading.

The kernels that the ICP loop runs (K1, K2, K3, P) also count
themselves on the device, in ``tally(device)``: each launch adds one to
its kernel's row, and a predicated launch of K1 or K3 that was not the
selected arm (the hierarchical search launches every arm and the
device's arm code picks one) adds one to its second column as it
returns.  A replayed CUDA graph runs no wrapper, so the loop books each
replay's launches from the tally (``book_replay``), and ``launch_counts``
reads the predicated launches that did no work as ``K1 skipped`` and
``K3 skipped``.
"""

from __future__ import annotations

from typing import Optional

import torch

KERNELS = ("K1", "K2", "K3", "K4_denom", "K4_moments", "K5_denom", "K5_moments", "P")
# the kernels that count themselves on the device (rows of the tally) and
# their wrapper modules
TALLIED = {"K1": "nn_dense", "K2": "bound", "K3": "nn_cand", "P": "procrustes"}
# the predicated kernels: their launches that returned at once
SKIPPED = ("K1 skipped", "K3 skipped")

# device index -> i32[len(TALLIED), 2] (launches run, launches skipped)
_TALLIES: dict = {}


def _modules() -> dict:
    from tpuslam_torch.kernels import bound, nn_cand, nn_dense, procrustes

    return {"nn_dense": nn_dense, "bound": bound, "nn_cand": nn_cand,
            "procrustes": procrustes}


def tally(device) -> Optional[torch.Tensor]:
    """The launch tally on ``device``: i32[4, 2], a row for each kernel of
    ``TALLIED`` in order (launches run, predicated launches skipped),
    made once and kept at its address, as CUDA graphs record it; None on
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _TALLIES:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the launch tally must exist before a CUDA graph is captured")
        _TALLIES[index] = torch.zeros((len(TALLIED), 2), dtype=torch.int32,
                                      device=torch.device("cuda", index))
    return _TALLIES[index]


def tally_ptr(name: str, device) -> int:
    """The address of kernel ``name``'s row of the tally on ``device``."""
    t = tally(device)
    return t[list(TALLIED).index(name)].data_ptr()


def counting() -> bool:
    """False while the current stream is being captured into a CUDA
    graph: a wrapper counts a launch only when it launches."""
    return not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def book_replay(delta: list, batch: int) -> None:
    """Add a replayed graph's launches, as the device's tally recorded
    them (``delta``: each ``TALLIED`` kernel's launches run, in order), to
    the wrappers' counters; every kernel of the loop runs at the loop's
    ``batch``."""
    mods = _modules()
    for name, n in zip(TALLIED.values(), delta):
        if n:
            mod = mods[name]
            mod.LAUNCHES += n
            mod.BATCH_LAUNCHES[batch] += n


def launch_counts() -> dict:
    """Each kernel's launches so far in this process, by its name in
    ``KERNELS``, and the predicated launches of K1 and K3 that returned
    at once (``SKIPPED``, read from the device's tally)."""
    from tpuslam_torch.kernels import bound, cpd_cand, cpd_dense, nn_cand, nn_dense, procrustes

    counts = dict(zip(KERNELS, (
        nn_dense.LAUNCHES, bound.LAUNCHES, nn_cand.LAUNCHES, cpd_dense.DENOM_LAUNCHES,
        cpd_dense.MOMENTS_LAUNCHES, cpd_cand.DENOM_LAUNCHES, cpd_cand.MOMENTS_LAUNCHES,
        procrustes.LAUNCHES)))
    skipped = [0, 0]
    for t in _TALLIES.values():
        col = t[:, 1].tolist()
        skipped[0] += col[0]
        skipped[1] += col[2]
    counts.update(zip(SKIPPED, skipped))
    return counts


def launch_delta(before: dict) -> dict:
    """The launches since ``before`` (a ``launch_counts()`` reading)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def reset_launch_counts() -> None:
    from tpuslam_torch.kernels import bound, cpd_cand, cpd_dense, nn_cand, nn_dense, procrustes

    nn_dense.LAUNCHES = bound.LAUNCHES = nn_cand.LAUNCHES = procrustes.LAUNCHES = 0
    cpd_dense.DENOM_LAUNCHES = cpd_dense.MOMENTS_LAUNCHES = 0
    cpd_cand.DENOM_LAUNCHES = cpd_cand.MOMENTS_LAUNCHES = 0
    for t in _TALLIES.values():
        t.zero_()
