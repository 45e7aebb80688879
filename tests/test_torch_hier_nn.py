"""The hierarchical exact NN of the PyTorch port
(``tpuslam_torch.ops.nn_hier``) against the JAX package's
(``tpuslam.ops.nn_hier``, Pallas kernels in interpret mode) and the
dense oracle.

Each case of ``tests/test_hier_nn.py`` that has a counterpart in the
port is mirrored here: the port's ``nearest_neighbors_hier`` must be
bit-identical (idx and dist) to the JAX package's and to the oracle on
every valid source, whatever arm it takes, and must take the sparse arms
where the JAX tests require them.  The TPU-only knobs (the SMEM table
segmentation, the pre-round-3 chunked bound pass) have no counterpart.
``prepare_hier_target``'s fields must equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import random_rigid
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam.ops import nn_hier as jax_hier
from tpuslam.ops.nn import nearest_neighbors_ref as jax_nn_ref
from tpuslam.ops.spatial import morton_permutation as jax_morton
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.ops import nn_hier

# the port runs on the card unless asked for the CPU; these tests ask
CPU = "cpu"


class Both:
    """One target prepared by both packages, and both packages' states."""

    def __init__(self, tgt_points, count, m, n, g=128):
        self.jt = jax_pad_cloud(tgt_points[:count], multiple=m)
        self.tt = pad_cloud(tgt_points[:count], multiple=m, device=CPU)
        self.jax_target = jax_hier.prepare_hier_target(
            self.jt.points, self.jt.mask(), self.jt.count, g=g)
        self.target = nn_hier.prepare_hier_target(
            self.tt.points, self.tt.mask(), self.tt.count, g=g)
        self.jax_state = jax_hier.hier_state_init(n)
        self.state = nn_hier.hier_state_init(n)
        self.count = count

    def query(self, pos, mask, **kw):
        """Both packages' (idx, dist) at the sorted positions ``pos``;
        asserts them bit-identical to each other and to the oracle."""
        j_idx, j_dist, self.jax_state = jax_hier.nearest_neighbors_hier(
            jnp.asarray(pos), jnp.asarray(mask), self.jax_target,
            self.jax_state, interpret=True, **kw)
        idx, dist, self.state = nn_hier.nearest_neighbors_hier(
            torch.from_numpy(pos), torch.from_numpy(mask), self.target,
            self.state, **kw)
        o_idx, o_dist = jax_nn_ref(
            jnp.asarray(pos), self.jt.points, self.jt.count)
        valid = mask > 0
        for i, d in ((np.asarray(j_idx), np.asarray(j_dist)),
                     (np.asarray(o_idx), np.asarray(o_dist))):
            np.testing.assert_array_equal(idx.numpy()[valid], i[valid])
            np.testing.assert_array_equal(dist.numpy()[valid], d[valid])
        return idx.numpy(), dist.numpy()

    @property
    def sparse(self):
        return bool(self.state.sparse)


def _sorted(src):
    mask = np.ones(src.shape[0], np.float32)
    perm = np.asarray(jax_morton(jnp.asarray(src), jnp.asarray(mask)))
    return src[perm], mask


@pytest.mark.parametrize("n,m,count", [
    (1024, 2048, 2048),
    (2048, 2048, 1800),
    (1024, 4096, 4096),
])
def test_hier_matches_jax_and_dense(rng, n, m, count):
    """Cold start and a warm query."""
    src = (rng.random((n, 3)) * 10.0).astype(np.float32)
    tgt = (rng.random((m, 3)) * 10.0).astype(np.float32)
    both = Both(tgt, count, m, n)
    pos, mask = _sorted(src)
    both.query(pos, mask)
    r, t = random_rigid(rng, angle=0.02, trans=0.05)
    both.query((pos @ r.T + t).astype(np.float32), mask)


def test_prepare_hier_target_fields_equal_jax(rng):
    m, count = 4096, 3000
    tgt = (rng.random((m, 3)) * 10.0 - 4.0).astype(np.float32)
    both = Both(tgt, count, m, 1024)
    for field in ("packed", "radii", "center_ref", "cmax", "original_points"):
        np.testing.assert_array_equal(
            getattr(both.target, field).numpy(),
            np.asarray(getattr(both.jax_target, field)), err_msg=field)
    assert both.target.caug.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        both.target.caug.float().numpy(),
        np.asarray(both.jax_target.caug.astype(jnp.float32)))


def test_hier_warm_drift_stays_exact(rng):
    """Small rigid steps: every query exact, the sparse arm engaged."""
    n, m = 1024, 2048
    src = (rng.random((n, 3)) * 10.0).astype(np.float32)
    both = Both((rng.random((m, 3)) * 10.0).astype(np.float32), m, m, n)
    pos, mask = _sorted(src)
    sparse_hits = 0
    nn_hier.ARM_TRACE.clear()
    for _ in range(5):
        both.query(pos, mask)
        sparse_hits += both.sparse
        r, t = random_rigid(rng, angle=0.01, trans=0.02)
        pos = (pos @ r.T + t).astype(np.float32)
    assert sparse_hits >= 3
    assert list(nn_hier.ARM_TRACE).count("fine") == sparse_hits


def test_hier_large_jump_overflows_and_stays_exact(rng):
    n = m = 4096
    src = (rng.random((n, 3)) * 10.0).astype(np.float32)
    both = Both((rng.random((m, 3)) * 10.0).astype(np.float32), m, m, n)
    pos, mask = _sorted(src)
    both.query(pos, mask, l_budget=8)
    both.query(pos + np.float32([7.0, -3.0, 5.0]), mask, l_budget=8)
    assert not both.sparse  # overflowed to dense
    assert nn_hier.ARM_TRACE[-1] == "dense"


def test_hier_near_tie_cases(rng):
    """Near-duplicates and exact duplicates: ties decided by the exact
    distance and the lowest original index, through the warm sparse arm
    at zero motion."""
    n, m = 1024, 4096
    base = (rng.random((n, 3)) * 4.0).astype(np.float32)
    tgt = np.concatenate([
        base + np.float32(1e-4) * rng.standard_normal((n, 3)).astype(np.float32),
        base + np.float32(1e-4) * rng.standard_normal((n, 3)).astype(np.float32),
        base,
        base,
    ]).astype(np.float32)
    both = Both(tgt, m, m, n)
    pos, mask = _sorted(base)
    both.query(pos, mask)
    idx, dist = both.query(pos, mask)
    assert both.sparse
    assert np.all(dist == 0.0) and np.all(idx >= 2 * n) and np.all(idx < 3 * n)


def test_hier_padded_target_rows_never_win(rng):
    n, m, count = 1024, 4096, 1100
    src = (rng.random((n, 3)) * 10.0).astype(np.float32)
    both = Both((rng.random((m, 3)) * 10.0).astype(np.float32), count, m, n)
    pos, mask = _sorted(src)
    both.query(pos, mask)
    idx, _ = both.query(pos, mask)
    assert both.sparse
    assert int(idx.max()) < count


def test_hier_masked_sources(rng):
    """Invalid source rows admit nothing and do not disturb the valid
    rows' results."""
    n, m = 2048, 4096
    src = (rng.random((n, 3)) * 10.0).astype(np.float32)
    both = Both((rng.random((m, 3)) * 10.0).astype(np.float32), m, m, n)
    pos, mask = _sorted(src)
    mask[1500:] = 0.0
    both.query(pos, mask)
    both.query(pos, mask)
    assert both.sparse


@pytest.mark.parametrize("l_budget,arm", [(8, "dense"), (24, "dense"), (1000, "fine")])
def test_coarse_middle_arm_exact(rng, l_budget, arm):
    """Whatever arm the budget routes to, the result is exact.  With this
    loose bound every group admits most coarse tiles, over the coarse
    budget (at most 5/8 of them), so 24 goes dense as 8 does; the
    routing test below drives the coarse arm."""
    n, m = 2048, 8192  # g=128 -> C=64; g2=512 -> C2=16
    src = (rng.random((n, 3)) * 10.0).astype(np.float32)
    both = Both((rng.random((m, 3)) * 10.0).astype(np.float32), m, m, n)
    pos, mask = _sorted(src)
    # a warm state whose bound is loose: every source points at row 0
    both.state = both.state._replace(
        prev_target=both.tt.points[0].expand(n, 3).clone(), warm=torch.tensor(True))
    both.jax_state = both.jax_state._replace(
        prev_target=jnp.broadcast_to(both.jt.points[0], (n, 3)), warm=jnp.asarray(True))
    both.query(pos, mask, l_budget=l_budget, g=128, gsrc=1024)
    assert nn_hier.ARM_TRACE[-1] == arm


def test_coarse_middle_arm_routing(rng, monkeypatch):
    """Routing with a stubbed bound pass: a few scattered fine tiles take
    the fine arm, 20 contiguous fine tiles (5 coarse) the coarse arm, 40
    fine tiles (10 coarse, over the coarse budget 8) the dense arm; each
    arm scans exactly its own rows."""
    n, m = 2048, 8192
    g, gsrc, budget = 128, 1024, 8
    src = (rng.random((n, 3)) * 10.0).astype(np.float32)
    both = Both((rng.random((m, 3)) * 10.0).astype(np.float32), m, m, n)
    pos, mask = _sorted(src)
    crafted = {}
    # the solo search is the batch form's batch of one
    monkeypatch.setattr(nn_hier, "bound_pass_batch", lambda *a, **k: crafted["adm"][None])
    packed = both.target.packed.numpy()

    def brute(rows):
        pts = packed[rows, :3]
        d = ((pos[:, None, :] - pts[None]) ** 2).sum(-1)
        best = d.argmin(axis=1)
        return packed[rows, 3][best].astype(np.int32)

    for tiles, arm in (([0, 8, 16, 24], "fine"), (list(range(20)), "coarse"),
                       (list(range(40)), "dense")):
        adm = torch.zeros((n // gsrc, m // g), dtype=torch.bool)
        adm[:, tiles] = True
        crafted["adm"] = adm
        idx, _, _ = nn_hier.nearest_neighbors_hier(
            torch.from_numpy(pos), torch.from_numpy(mask), both.target,
            both.state, l_budget=budget, g=g, gsrc=gsrc)
        assert nn_hier.ARM_TRACE[-1] == arm
        if arm != "dense":
            rows = np.concatenate([np.arange(t * g, (t + 1) * g) for t in tiles])
            np.testing.assert_array_equal(idx.numpy(), brute(rows))


@pytest.mark.parametrize("m", [512, 8192, 102_400, 655_360, 1_048_576, 1_310_720, 16_000_000])
def test_auto_tile_params_equal_jax(m):
    assert nn_hier.auto_tile_params(m) == jax_hier.auto_tile_params(m)
    g, gsrc, l_budget = nn_hier.auto_tile_params(m)
    assert m // g <= 2560 or g == 128
    assert nn_hier.table_width(m, g, l_budget) == jax_hier.table_width(m, g, l_budget)
    assert nn_hier._coarse_tile_rows(g, gsrc) == jax_hier._coarse_tile_rows(g, gsrc)


def test_target_of_2_24_rows_raises():
    pts = torch.zeros((2**24, 3))
    with pytest.raises(ValueError, match="2\\^24"):
        nn_hier.prepare_hier_target(pts, torch.ones(2**24), torch.tensor(2**24), g=8192)
