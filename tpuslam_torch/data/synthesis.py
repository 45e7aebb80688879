"""Cloud synthesis pipeline mirroring ``GetCloudsFromConfig``
(``common.cpp:134-210``): load -> subsample -> normalize -> shuffle -> noise
-> outliers -> rigid transform of the *after* cloud.

A numpy-only copy of ``tpuslam/data/synthesis.py`` (less
``inverse_permutation``, which the slice does not use): importing the
original runs ``tpuslam/__init__.py``, which imports JAX.  Host-side data
preparation, not a hot path; ``tests/test_torch_types.py`` pins every
function here to its original, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpuslam_torch.config.configuration import Configuration
from tpuslam_torch.data.loader import load_cloud


def get_random_permutation(rng: np.random.Generator, size: int) -> np.ndarray:
    """Mirrors ``GetRandomPermutationVector`` (``common.cpp:554-560``)."""
    return rng.permutation(size)


def apply_permutation(values: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Mirrors ``ApplyPermutation`` (``common.h:100-108``): identity padding
    past the permutation length; every index must be ``< len(values)``
    (numpy raises IndexError otherwise)."""
    out = np.array(values, copy=True)
    k = min(len(perm), len(values))
    out[:k] = values[perm[:k]]
    return out


def get_subcloud(
    rng: np.random.Generator, cloud: np.ndarray, subcloud_size: int
) -> np.ndarray:
    """Random subsample via permutation prefix (``common.cpp:25-37``);
    returns the cloud unchanged when it is already small enough."""
    if subcloud_size >= len(cloud):
        return cloud
    idx = get_random_permutation(rng, len(cloud))[:subcloud_size]
    return cloud[idx]


def cloud_boundaries(cloud: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis (min, max) corners (``common.cpp:57-70``)."""
    return cloud.min(axis=0), cloud.max(axis=0)


def cloud_spread(cloud: np.ndarray) -> float:
    """Largest per-axis extent (``common.cpp:72-79``)."""
    lo, hi = cloud_boundaries(cloud)
    return float((hi - lo).max())


def normalize_cloud(cloud: np.ndarray, size: float) -> np.ndarray:
    """Scale the cloud (about its center of mass) so its largest extent is
    ``size``, then restore the original center (``common.cpp:81-95``)."""
    center = cloud.mean(axis=0)
    aligned = cloud - center
    spread = cloud_spread(aligned)
    if abs(spread) < 1e-15:
        return cloud
    return aligned * (size / spread) + center


def add_noise(
    rng: np.random.Generator,
    cloud: np.ndarray,
    affected_share: float,
    intensity: float,
) -> np.ndarray:
    """Uniform per-coordinate jitter of magnitude <= spread*intensity applied
    to a random subset of points (``common.cpp:97-119``)."""
    n = len(cloud)
    count = int(np.clip(round(affected_share * n), 0, n))
    mask = np.zeros(n, dtype=bool)
    mask[:count] = True
    mask = apply_permutation(mask, get_random_permutation(rng, n))
    max_move = cloud_spread(cloud) * intensity
    out = cloud.copy()
    jitter = rng.uniform(-max_move, max_move, size=(int(mask.sum()), 3))
    out[mask] += jitter.astype(np.float32)
    return out


def add_outliers(
    rng: np.random.Generator, cloud: np.ndarray, count: int
) -> np.ndarray:
    """Append ``count`` uniform points inside the cloud's bounding box
    (``common.cpp:121-132``)."""
    if count <= 0:
        return cloud
    lo, hi = cloud_boundaries(cloud)
    extra = rng.uniform(lo, hi, size=(count, 3)).astype(np.float32)
    return np.concatenate([cloud, extra], axis=0)


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


def get_random_rotation_matrix(
    rng: np.random.Generator, angle_radians: float
) -> np.ndarray:
    """Random axis (uniform in the unit cube [0,1]^3, normalized), FIXED
    angle — exactly the reference's distribution (``testutils.cpp:42-47``)."""
    axis = rng.uniform(0.0, 1.0, size=3)
    return rotation_about_axis(axis, angle_radians)


def get_random_translation_vector(
    rng: np.random.Generator, magnitude: float
) -> np.ndarray:
    """Random direction (uniform in [-1,1]^3, normalized) times a FIXED
    magnitude (``testutils.cpp:49-54``)."""
    d = rng.uniform(-1.0, 1.0, size=3)
    d = d / np.linalg.norm(d)
    return (d * magnitude).astype(np.float32)


def transform_cloud(
    cloud: np.ndarray,
    rotation: np.ndarray,
    translation: np.ndarray,
    scale: float = 1.0,
) -> np.ndarray:
    """``p -> scale * (R @ p) + t`` over the whole cloud
    (``common.cpp:219-231``)."""
    return (scale * (cloud @ np.asarray(rotation, dtype=np.float32).T)
            + np.asarray(translation, dtype=np.float32)).astype(np.float32)


def get_clouds_from_config(
    config: Configuration,
) -> Tuple[np.ndarray, np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """The full synthesis pipeline (``common.cpp:134-210``).

    Returns ``(before, after, (rotation, translation))`` — the applied ground
    truth transform is returned too (tests use it as the oracle).
    """
    seed = (
        int(config.random_seed)
        if config.random_seed is not None
        else int(np.random.SeedSequence().entropy % (2**32))
    )
    rng = np.random.Generator(np.random.PCG64(seed))

    def resolve_ground_truth():
        if config.transformation is not None:
            rotation, translation = config.transformation
            return (
                np.asarray(rotation, dtype=np.float32),
                np.asarray(translation, dtype=np.float32),
            )
        if config.transformation_parameters is not None:
            rotation_val, translation_val = config.transformation_parameters
            return (
                get_random_rotation_matrix(rng, rotation_val),
                get_random_translation_vector(rng, translation_val),
            )
        raise ValueError("Wrong configuration: no transformation provided")

    same = config.before_path == config.after_path
    before = load_cloud(config.before_path)
    after = before.copy() if same else load_cloud(config.after_path)

    if len(before) == 0 or len(after) == 0:
        # a failed load yields a (0, 3) cloud; every stage below reduces
        # over points and would crash on it
        rotation, translation = resolve_ground_truth()
        return before, after, (rotation, translation)

    if config.cloud_before_resize is not None:
        before = get_subcloud(rng, before, int(config.cloud_before_resize))
    if config.cloud_after_resize is not None:
        after = get_subcloud(rng, after, int(config.cloud_after_resize))

    if config.cloud_spread is not None:
        before = normalize_cloud(before, float(config.cloud_spread))
        after = normalize_cloud(after, float(config.cloud_spread))

    before = before[get_random_permutation(rng, len(before))]
    after = after[get_random_permutation(rng, len(after))]

    if config.noise_affected_points_before is not None:
        before = add_noise(
            rng, before, config.noise_affected_points_before,
            config.noise_intensity_before,
        )
    if config.noise_affected_points_after is not None:
        after = add_noise(
            rng, after, config.noise_affected_points_after,
            config.noise_intensity_after,
        )

    before = add_outliers(rng, before, config.additional_outliers_before)
    after = add_outliers(rng, after, config.additional_outliers_after)

    rotation, translation = resolve_ground_truth()
    after = transform_cloud(after, rotation, translation)
    return before, after, (rotation, translation)
