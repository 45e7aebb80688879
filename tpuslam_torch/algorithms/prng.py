"""The JAX package's uniform draw and top-k order, in torch.

NICP picks its subcloud with ``jax.random.uniform(jax.random.PRNGKey(seed),
(n,))`` and ``lax.top_k`` (``tpuslam/algorithms/nicp.py:297-302``).  The
port cannot call JAX, so it draws the same bits itself.  In JAX 0.9 with
``jax_threefry_partitionable`` on (its default) and 64-bit mode off, the
draw is, for element ``i``:

* the key is ``(0, seed & 0xFFFFFFFF)``: ``PRNGKey`` keeps the low word
  (``PRNGKey(2**32 + 7)`` is ``[0, 7]``);
* ``(x0, x1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``, and the
  bits are ``x0 ^ x1``;
* the float is ``(bits >> 9) | 0x3F800000`` read as float32, minus 1.0.

Each value depends on ``i`` alone, not on ``n``, so clouds padded to
different sizes draw the same score for a row.  Torch's uint32 supports
few operations, so the words are int64 tensors kept below 2**32 by a
mask; everything runs on the device the caller names.

``top_k_order`` is ``lax.top_k``'s order: descending, the lower index
first on ties.  The scores take 2**23 values, so ties are common at a
million draws; ``torch.topk`` promises no order among them, a stable
descending sort does.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011, as in
    ``jax._src.prng``), of the int64 words ``x0``, ``x1`` (each below
    2**32) under ``key`` = two Python ints below 2**32."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def uniform(seed: int, n: int, device=None) -> torch.Tensor:
    """f32[n] in [0, 1): ``jax.random.uniform(jax.random.PRNGKey(seed),
    (n,))`` bit for bit (module docstring)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32((0, int(seed) & MASK), i >> 32, i & MASK)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000  # below 2**31: fits int32
    return bits.to(torch.int32).view(torch.float32) - 1.0


def top_k_order(scores: torch.Tensor, k: int) -> torch.Tensor:
    """int64[..., k]: the indices of the ``k`` largest scores along the
    last axis in ``lax.top_k``'s order (descending, lower index first on
    ties)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
