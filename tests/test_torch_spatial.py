"""Morton order and tile bounds of the PyTorch port
(``tpuslam_torch.ops.spatial``) against the JAX package's
(``tpuslam.ops.spatial``): codes, permutation and bounds must be equal
bit for bit, so that both packages sort, tile and sum in one order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuslam.ops import spatial as jax_spatial
from tpuslam_torch.ops import spatial


def _cloud(rng, n, n_valid, lo=-3.0, spread=10.0):
    pts = (rng.random((n, 3)) * spread + lo).astype(np.float32)
    pts[n_valid:] = 0.0  # padded rows, as pad_cloud leaves them
    mask = (np.arange(n) < n_valid).astype(np.float32)
    return pts, mask


CASES = [(1024, 1024), (4096, 3999), (2048, 1), (384, 0)]


@pytest.mark.parametrize("n,n_valid", CASES)
def test_morton_codes_and_permutation_bit_identical(rng, n, n_valid):
    pts, mask = _cloud(rng, n, n_valid)
    codes = spatial.morton_codes(torch.from_numpy(pts), torch.from_numpy(mask))
    perm = spatial.morton_permutation(torch.from_numpy(pts), torch.from_numpy(mask))
    assert codes.dtype == torch.int32 and perm.dtype == torch.int32
    np.testing.assert_array_equal(
        codes.numpy(),
        np.asarray(jax_spatial.morton_codes(jnp.asarray(pts), jnp.asarray(mask))),
    )
    np.testing.assert_array_equal(
        perm.numpy(),
        np.asarray(jax_spatial.morton_permutation(jnp.asarray(pts), jnp.asarray(mask))),
    )
    # invalid rows sort last
    assert set(perm.numpy()[n_valid:]) == set(range(n_valid, n))


def test_equal_codes_keep_their_order():
    pts = np.zeros((256, 3), np.float32)
    pts[::2] = 1.0  # two distinct points, each 128 times
    perm = spatial.morton_permutation(torch.from_numpy(pts), torch.ones(256))
    np.testing.assert_array_equal(
        perm.numpy(), np.concatenate([np.arange(1, 256, 2), np.arange(0, 256, 2)])
    )


@pytest.mark.parametrize("n,n_valid,tile", [(1024, 1000, 128), (4096, 300, 512), (512, 512, 64)])
def test_tile_bounds_bit_identical(rng, n, n_valid, tile):
    pts, mask = _cloud(rng, n, n_valid)
    perm = np.asarray(jax_spatial.morton_permutation(jnp.asarray(pts), jnp.asarray(mask)))
    sp, sm = pts[perm], mask[perm]
    ours = spatial.tile_bounds(torch.from_numpy(sp), torch.from_numpy(sm), tile)
    ref = jax_spatial.tile_bounds(jnp.asarray(sp), jnp.asarray(sm), tile)
    np.testing.assert_array_equal(ours.centers.numpy(), np.asarray(ref.centers))
    np.testing.assert_array_equal(ours.radii.numpy(), np.asarray(ref.radii))
    empty = sm.reshape(-1, tile).sum(axis=1) == 0
    assert np.all(ours.centers.numpy()[empty] == 1e15)
    assert np.all(ours.radii.numpy()[empty] == 0.0)


@pytest.mark.parametrize("n,n_valid", [(1000, 1000), (1000, 640), (64, 0)])
def test_host_morton_order_copy(rng, n, n_valid):
    pts, _ = _cloud(rng, n, n_valid)
    np.testing.assert_array_equal(
        spatial.host_morton_order(pts, n_valid),
        jax_spatial.host_morton_order(pts, n_valid),
    )
