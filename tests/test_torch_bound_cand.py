"""Kernels K2 (bound pass) and K3 (candidate rescore) of the PyTorch port
and the candidate table between them, against the JAX package.

On the CPU each wrapper runs its plain version:

* K2's plain version (``tpuslam_torch.kernels.bound``) must admit the
  same tiles as ``bound_pass_pallas(interpret=True)`` on the same
  operands, and a superset of the tiles that hold each valid source's
  true nearest neighbour;
* ``_build_cand_table`` must equal the JAX package's table;
* K3's plain version (``tpuslam_torch.kernels.nn_cand``) must be
  bit-identical (idx and dist) to ``nearest_neighbors_cand(interpret=True)``
  and, where every true nearest neighbour is admitted, to the dense
  oracle, in the fine and the coarse arm.

The CUDA kernels are held to the plain versions in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam.kernels.pallas_bound import bound_pass_pallas, bound_pass_pallas_batch
from tpuslam.kernels.pallas_nn_cand import nearest_neighbors_cand as jax_cand
from tpuslam.ops import nn_hier as jax_hier
from tpuslam.ops.nn import nearest_neighbors_ref as jax_nn_ref
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.kernels import bound, nn_cand
from tpuslam_torch.ops import nn_hier
from tpuslam_torch.ops.nn import nearest_neighbors_ref
from tpuslam_torch.ops.spatial import morton_permutation


def _problem(rng, n, m, count, g=128):
    """Sorted sources, their mask, the prepared target and the Cloud."""
    src = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32))
    mask = torch.ones(n)
    src = src[morton_permutation(src, mask).long()].contiguous()
    cloud = pad_cloud((rng.random((count, 3)) * 10).astype(np.float32), multiple=m)
    target = nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count, g=g)
    return src, mask, target, cloud


def _warm_state(src, target, cloud, noise, rng):
    """A warm state: each source's true match, then a small move."""
    idx, _ = nearest_neighbors_ref(src, cloud.points, cloud.count)
    state = nn_hier.HierState(
        prev_target=cloud.points[idx.long()],
        warm=torch.tensor(True), sparse=torch.tensor(False),
    )
    moved = src + torch.from_numpy(
        (rng.standard_normal(src.shape) * noise).astype(np.float32))
    return moved, state


def _true_tiles(src, target, cloud, g):
    """The sorted-target tile of each source's true nearest neighbour."""
    idx, _ = nearest_neighbors_ref(src, cloud.points, cloud.count)
    m = target.packed.shape[0]
    inv = torch.empty(m, dtype=torch.long)
    valid = target.packed[:, 3] < 1e30
    inv[target.packed[valid, 3].long()] = torch.arange(m)[valid]
    return inv[idx.long()] // g


def _jax_bound(saug, aux, caug, radii, eps, warm, gsrc):
    return np.asarray(bound_pass_pallas(
        jnp.asarray(saug.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(aux.numpy()),
        jnp.asarray(caug.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(radii.numpy()), jnp.asarray(eps.numpy()),
        jnp.asarray(bool(warm)), gsrc=gsrc, interpret=True,
    ))


@pytest.mark.parametrize("case", ["cold", "warm", "padded_target"])
def test_bound_pass_plain_admits_as_pallas(rng, case):
    """Same operands, same admitted sets as the Pallas kernel; and every
    valid source's true tile admitted."""
    n, m, count = 2048, 4096, 4096
    if case == "padded_target":
        count = 1500
    src, mask, target, cloud = _problem(rng, n, m, count)
    state = nn_hier.hier_state_init(n)
    if case == "warm":
        src, state = _warm_state(src, target, cloud, 0.05, rng)
    mask[-37:] = 0.0  # a few invalid sources
    saug, aux, eps = nn_hier.bound_operands(src, mask, target, state)
    adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, 1024)
    assert adm.shape == (2, m // 128) and adm.dtype == torch.bool
    np.testing.assert_array_equal(
        adm.numpy(),
        _jax_bound(saug, aux, target.caug, target.radii, eps, state.warm, 1024),
    )
    tiles = _true_tiles(src, target, cloud, 128)
    groups = torch.arange(n) // 1024
    assert bool(adm[groups[mask > 0], tiles[mask > 0]].all())
    if case == "warm":
        assert int(adm.sum(1).max()) < m // 128  # the warm bound prunes


def test_bound_pass_batch_matches_each_pair(rng):
    n, m = 1024, 2048
    ops = []
    for noise in (0.0, 0.3):
        src, mask, target, cloud = _problem(rng, n, m, m)
        moved, state = _warm_state(src, target, cloud, noise, rng)
        saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
        ops.append((saug, aux, target.caug, target.radii, eps, state.warm))
    stacked = [torch.stack([o[k] for o in ops]) for k in range(6)]
    batch = bound.bound_pass_batch(*stacked, gsrc=512)
    assert batch.shape == (2, 2, m // 128)
    for p in range(2):
        assert torch.equal(batch[p], bound.bound_pass(*ops[p], gsrc=512))
    ref = bound_pass_pallas_batch(
        jnp.asarray(stacked[0].float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(stacked[1].numpy()),
        jnp.asarray(stacked[2].float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(stacked[3].numpy()), jnp.asarray(stacked[4].numpy()),
        jnp.asarray(stacked[5].numpy()), gsrc=512, interpret=True,
    )
    np.testing.assert_array_equal(batch.numpy(), np.asarray(ref))


def test_bound_pass_rejects_bad_operands(rng):
    src, mask, target, cloud = _problem(rng, 1024, 2048, 2048)
    state = nn_hier.hier_state_init(1024)
    saug, aux, eps = nn_hier.bound_operands(src, mask, target, state)
    with pytest.raises(ValueError, match="multiple of gsrc"):
        bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, 1000)
    with pytest.raises(TypeError, match="bfloat16"):
        bound.bound_pass(saug.float(), aux, target.caug, target.radii, eps,
                         state.warm, 1024)


@pytest.mark.parametrize("ts,c,width,p", [
    (7, 40, 8, 0.3),  # counts above the width
    (7, 40, 40, 0.3),  # width equal to the tile count
    (16, 64, 16, 0.05),  # sparse rows
    (3, 24, 24, 1.0),  # full rows
])
def test_cand_table_equals_jax(rng, ts, c, width, p):
    adm = torch.from_numpy(rng.random((ts, c)) < p)
    adm[0] = False  # an empty group
    counts = adm.sum(1, dtype=torch.int32)
    ours = nn_hier._build_cand_table(adm, counts, width)
    ref = jax_hier._build_cand_table(
        jnp.asarray(adm.numpy()), jnp.asarray(counts.numpy()), width)
    assert ours.dtype == torch.int32 and ours.shape == (ts, width)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert np.all(ours.numpy()[0] == 0)


def _fine_and_coarse(adm, m, g):
    """(cand, counts, g) of the fine arm and of the coarse arm (tiles of
    512 rows), each with room for every admitted tile."""
    counts = adm.sum(1, dtype=torch.int32)
    fine = (nn_hier._build_cand_table(adm, counts, nn_hier.table_width(m, g, m)),
            counts, g)
    adm2 = nn_hier.coarse_admission(adm, g, 512)
    counts2 = adm2.sum(1, dtype=torch.int32)
    coarse = (nn_hier._build_cand_table(adm2, counts2, nn_hier.table_width(m, 512, m)),
              counts2, 512)
    return fine, coarse


@pytest.mark.parametrize("arm", ["fine", "coarse"])
def test_cand_rescore_bit_identical(rng, arm):
    """K3's plain version against the Pallas kernel (interpret) and the
    dense oracle, on the warm table of a padded target (every group's
    admitted tiles within the arm's budget, so the oracle's answer is
    among them)."""
    n, m, count, gsrc = 2048, 8192, 8000, 128
    src, mask, target, cloud = _problem(rng, n, m, count)
    moved, state = _warm_state(src, target, cloud, 0.02, rng)
    saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
    adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, gsrc)
    fine, coarse = _fine_and_coarse(adm, m, 128)
    cand, counts, g = fine if arm == "fine" else coarse
    assert bool((counts < m // g).any())  # a real subset
    idx, dist = nn_cand.nearest_neighbors_cand(
        moved, target.packed, cand, counts, g=g, gsrc=gsrc)
    j_idx, j_dist = jax_cand(
        jnp.asarray(moved.numpy()), jnp.asarray(target.packed.numpy()),
        jnp.asarray(cand.numpy()), jnp.asarray(counts.numpy()),
        g=g, gsrc=gsrc, interpret=True,
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(j_dist))
    o_idx, o_dist = jax_nn_ref(
        jnp.asarray(moved.numpy()), jnp.asarray(cloud.points.numpy()),
        jnp.int32(count))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(o_idx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(o_dist))


def test_cand_rescore_ragged_counts_and_batch(rng):
    """Dead slots and empty groups: a group with no live slot reports
    (0, 3.4e38); a batch of two equals its pairs one by one; out-of-range
    tile ids are skipped."""
    n, m = 1024, 4096
    src, mask, target, cloud = _problem(rng, n, m, m)
    cand = torch.from_numpy(rng.integers(0, m // 128, size=(4, 16)).astype(np.int32))
    counts = torch.tensor([0, 3, 16, 9], dtype=torch.int32)
    idx, dist = nn_cand.nearest_neighbors_cand(
        src, target.packed, cand, counts, g=128, gsrc=256)
    assert bool((idx[:256] == 0).all()) and bool((dist[:256] == nn_cand.BIG).all())
    j_idx, j_dist = jax_cand(
        jnp.asarray(src.numpy()), jnp.asarray(target.packed.numpy()),
        jnp.asarray(cand.numpy()), jnp.asarray(counts.numpy()),
        g=128, gsrc=256, interpret=True,
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(j_dist))
    counts_b = torch.tensor([5, 0, 2, 16], dtype=torch.int32)
    b_idx, b_dist = nn_cand.nearest_neighbors_cand_batch(
        torch.stack([src, src]), torch.stack([target.packed] * 2),
        torch.stack([cand, cand]), torch.stack([counts, counts_b]), g=128, gsrc=256)
    assert torch.equal(b_idx[0], idx) and torch.equal(b_dist[0], dist)
    one = nn_cand.nearest_neighbors_cand(
        src, target.packed, cand, counts_b, g=128, gsrc=256)
    assert torch.equal(b_idx[1], one[0]) and torch.equal(b_dist[1], one[1])
    wild = cand.clone()
    wild[1, 1] = 10_000  # past the 32 tiles: skipped
    w_idx, _ = nn_cand.nearest_neighbors_cand(
        src, target.packed, wild, counts, g=128, gsrc=256)
    dropped = cand.clone()
    dropped[1, :2] = cand[1, [0, 2]]
    d_idx, _ = nn_cand.nearest_neighbors_cand(
        src, target.packed, dropped, torch.tensor([0, 2, 16, 9], dtype=torch.int32),
        g=128, gsrc=256)
    assert torch.equal(w_idx[256:512], d_idx[256:512])
