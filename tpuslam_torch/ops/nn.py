"""Nearest-neighbour correspondence search — the ICP hot loop (port of
``tpuslam/ops/nn.py``).

Two functions behind one signature (``src`` f32[N, 3], ``tgt`` f32[M, 3]
padded, ``tgt_count`` a 0-d int32 tensor -> (i32[N], f32[N])):

* ``nearest_neighbors_ref`` — the plain chunked PyTorch oracle on any
  device, bit-identical to the JAX oracle on the CPU;
* ``nearest_neighbors`` — the front: kernel K1 for a CUDA tensor, the
  plain version for a CPU tensor (``tpuslam_torch.kernels.nn_dense``).

Invalid target rows (index >= count) never win; the first (lowest)
target index wins a tie; zero valid targets give ``(0, 3.4e38)``.  A
padded source row's result is arbitrary — callers mask by the source
validity mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

# nearest_neighbors, the front, is K1's B=1 wrapper itself while the
# dense arm is the only one ported
from tpuslam_torch.kernels.nn_dense import (  # noqa: F401  (re-exports)
    BIG,
    REF_CHUNK,
    nearest_neighbors_dense as nearest_neighbors,
    nearest_neighbors_dense_ref,
)


def nearest_neighbors_ref(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_count: torch.Tensor,
    chunk: int = REF_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on ``src``'s device (the oracle)."""
    idx, dist = nearest_neighbors_dense_ref(
        src[None], tgt[None], torch.as_tensor(tgt_count).reshape(1), chunk
    )
    return idx[0], dist[0]

