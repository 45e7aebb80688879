"""The pairs a run sends: a seeded surface's vertex set, two subclouds
of it, and the upstream protocol's rigid motion, all made from ``--seed``.

The surface stands in for the upstream's meshes, which the repository
does not hold: a closed, star-shaped surface, a unit sphere whose radius
carries a few seeded Gaussian bumps (so it has no symmetry that traps
ICP).  A pair of N points is made as the upstream makes it
(``GetCloudsFromConfig``, ``common.cpp:134-210``): the mesh is the
smallest of the upstream's with at least N vertices
(``GetObjectWithMinSize``, ``testset.cpp:19-38``; its vertex counts are
the protocol's ``mesh_vertices``), here that many points of the surface;
``before`` and ``after`` are each a random permutation prefix of N of
those vertices (``GetSubcloud``), so they share about N/M of their
points; each is normalised to the configuration's spread as
``NormalizeCloud`` does, in a shuffled order; ``after`` is then moved by
a rotation of the protocol's angle about a random axis and a translation
of the protocol's length in a random direction (the draws of
``testutils.cpp:42-54``).  Every pair has a surface of its own.

A pool holds ``pool_pairs`` pairs, made on the device in a few large
calls and handed to the program as host arrays.  Request k of a size
takes pair k of that size's pool; past the pool's end it takes pair
k mod P re-posed: both clouds rotated about the origin by a fresh
rotation drawn from the seed and k, which keeps the protocol's angle and
translation length, so a cache keyed on the clouds never sees a pair
twice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BUMPS = 6  # Gaussian bumps on each surface
CHUNK_POINTS = 2**24  # vertices made in one call: bounds the device memory of a chunk


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``(seed, *stream)``; any whole ``seed``."""
    return np.random.default_rng([int(seed) % 2**63, *stream])


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from ``(seed, *stream)``."""
    return int(rng_for(seed, *stream).integers(0, 2**63 - 1))


# --- the protocol's draws, copied from tpuslam_torch/data/synthesis.py ---

def rotation_about_axis(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix about a (normalized) axis — the math behind
    ``glm::rotate`` used at ``testutils.cpp:42-47``."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    cc = 1.0 - c
    return np.array(
        [
            [c + x * x * cc, x * y * cc - z * s, x * z * cc + y * s],
            [y * x * cc + z * s, c + y * y * cc, y * z * cc - x * s],
            [z * x * cc - y * s, z * y * cc + x * s, c + z * z * cc],
        ],
        dtype=np.float32,
    )


def get_random_rotation_matrix(rng: np.random.Generator, angle_radians: float) -> np.ndarray:
    """Random axis (uniform in the unit cube [0,1]^3, normalized), FIXED
    angle — exactly the reference's distribution (``testutils.cpp:42-47``)."""
    axis = rng.uniform(0.0, 1.0, size=3)
    return rotation_about_axis(axis, angle_radians)


def get_random_translation_vector(rng: np.random.Generator, magnitude: float) -> np.ndarray:
    """Random direction (uniform in [-1,1]^3, normalized) times a FIXED
    magnitude (``testutils.cpp:49-54``)."""
    d = rng.uniform(-1.0, 1.0, size=3)
    d = d / np.linalg.norm(d)
    return (d * magnitude).astype(np.float32)


# --- the surface ---

def _uniform_rotation(rng: np.random.Generator) -> np.ndarray:
    """A rotation uniform over SO(3): the re-pose of a pool pair."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def mesh_vertices(protocol: dict, n: int) -> int:
    """The vertex count of the smallest upstream mesh with at least n."""
    fits = [m for m in protocol["mesh_vertices"] if m >= n]
    if not fits:
        raise ValueError(f"no mesh of the protocol has {n} vertices")
    return min(fits)


def _normalise(pts: torch.Tensor, spread: float) -> torch.Tensor:
    """``NormalizeCloud`` (common.cpp:81-95) on each cloud of ``pts``:
    scale about the centre of mass so that the largest extent is
    ``spread``, then restore the centre."""
    centre = pts.mean(dim=-2, keepdim=True)
    aligned = pts - centre
    extent = (aligned.amax(dim=-2) - aligned.amin(dim=-2)).amax(dim=-1)
    return aligned * (spread / extent)[..., None, None] + centre


def _subclouds(gen: torch.Generator, pairs: int, n: int, m: int, spread: float,
               device) -> torch.Tensor:
    """f32[pairs, 2, n, 3]: for each pair, m vertices of its own surface
    and two permutation prefixes of n of them, each normalised to
    ``spread``."""
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    centres = torch.randn(pairs, BUMPS, 3, **f32)
    centres = centres / centres.norm(dim=-1, keepdim=True)
    heights = torch.rand(pairs, 1, BUMPS, **f32) * 0.6 - 0.25  # radius 0.25 .. 1.35 at most
    widths = torch.rand(pairs, 1, BUMPS, **f32) * 0.25 + 0.08
    u = torch.randn(pairs, m, 3, **f32)
    u = u / u.norm(dim=-1, keepdim=True)
    cos = torch.einsum("pmk,pjk->pmj", u, centres)
    radius = 1.0 + torch.sum(heights * torch.exp((cos - 1.0) / widths), -1)
    vertices = u * radius[..., None]
    # GetSubcloud: a prefix of a random permutation, once for each cloud
    prefix = torch.rand(pairs, 2, m, **f32).argsort(dim=-1)[..., :n]
    picked = torch.gather(vertices[:, None].expand(pairs, 2, m, 3), 2,
                          prefix[..., None].expand(pairs, 2, n, 3))
    return _normalise(picked, spread)


class Pool(NamedTuple):
    """One size's pairs on the host, and each pair's true motion."""

    n: int
    before: np.ndarray  # f32[P, n, 3]
    after: np.ndarray  # f32[P, n, 3]
    rotation: np.ndarray  # f32[P, 3, 3]
    translation: np.ndarray  # f32[P, 3]


def make_pool(seed: int, n: int, pairs: int, protocol: dict, device, stream: int = 0) -> Pool:
    """``pairs`` pairs of ``n`` points from ``(seed, n, stream)``, made on
    ``device`` and returned on the host."""
    spread = float(protocol["cloud_spread"])
    m = mesh_vertices(protocol, n)
    angle, length = float(protocol["rotation_rad"]), float(protocol["translation"])
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, n, stream, 1))
    rng = rng_for(seed, n, stream, 2)
    rot = np.stack([get_random_rotation_matrix(rng, angle) for _ in range(pairs)])
    trans = np.stack([get_random_translation_vector(rng, length) for _ in range(pairs)])
    before = np.empty((pairs, n, 3), dtype=np.float32)
    after = np.empty((pairs, n, 3), dtype=np.float32)
    step = max(1, CHUNK_POINTS // m)
    for lo in range(0, pairs, step):
        hi = min(pairs, lo + step)
        clouds = _subclouds(gen, hi - lo, n, m, spread, device)
        r = torch.from_numpy(rot[lo:hi]).to(device)
        t = torch.from_numpy(trans[lo:hi]).to(device)
        moved = torch.einsum("pnk,pjk->pnj", clouds[:, 1], r) + t[:, None, :]
        before[lo:hi] = clouds[:, 0].cpu().numpy()
        after[lo:hi] = moved.cpu().numpy()
    return Pool(n, before, after, rot, trans)


class Pair(NamedTuple):
    before: np.ndarray
    after: np.ndarray
    rotation: np.ndarray  # the true motion: after ~ rotation @ before + translation
    translation: np.ndarray


def pair(pool: Pool, seed: int, k: int) -> Pair:
    """Request k's pair of this pool's size: pool pair k, or past the
    pool's end pair k mod P re-posed by a rotation drawn from (seed, k)."""
    p = len(pool.before)
    i = k % p
    b, a, r, t = pool.before[i], pool.after[i], pool.rotation[i], pool.translation[i]
    if k < p:
        return Pair(b, a, r, t)
    g = _uniform_rotation(rng_for(seed, pool.n, k, 3))
    return Pair(b @ g.T, a @ g.T, g @ r @ g.T, g @ t)
