"""Kernels K1 to K5, the ICP slice and the CPD slice of the PyTorch port
on a CUDA card.

Every test here needs a card and nvcc; without them each one skips (the
``cuda`` fixture decides, at run time).  The file imports neither JAX
nor ``tpuslam``, so it runs where JAX is not installed, without the
JAX-loading ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

On the card, K1 and K3 must be bit-identical (idx and dist) to their
plain versions (K3 at every tile size, whatever the order of a group's
slots, with ties planted across the blocks that split a group), K2 must
admit exactly what its plain version admits at every group size, the
hierarchical search must be bit-identical to K1, and a registration must
agree with the CPU run within 1e-4 in R and t (cuSOLVER against LAPACK,
sums in another order).  K4 must agree with its plain version within
1e-5 relative (the sums inside a block run in another order; the
Gaussian's distance and truncation are the same), and K5 must equal K4
bit for bit.
"""

import numpy as np
import pytest
import torch

import tpuslam_torch
from tpuslam_torch.data.synthesis import (
    get_random_rotation_matrix,
    get_random_translation_vector,
)
from tpuslam_torch.algorithms.icp import icp_register
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.algorithms.cpd import cpd_register
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.kernels import bound, cpd_cand, cpd_dense, nn_cand, nn_dense
from tpuslam_torch.ops import nn_hier
from tpuslam_torch.ops.nn import nearest_neighbors, nearest_neighbors_ref
from tpuslam_torch.ops.spatial import morton_permutation

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.Generator(np.random.PCG64(666))


@pytest.mark.parametrize("b,n,m,counts", [
    (1, 1000, 777, [500]),  # ragged count, sizes not multiples of 128
    (2, 300, 1000, [1000, 0]),  # a batch of two, one without targets
    (1, 4096, 8192, [8192]),
])
def test_kernel_bit_identical_to_plain(rng, cuda, b, n, m, counts):
    src = torch.from_numpy((rng.random((b, n, 3)) * 10).astype(np.float32))
    tgt = torch.from_numpy((rng.random((b, m, 3)) * 10).astype(np.float32))
    count = torch.tensor(counts, dtype=torch.int32)
    src, tgt, count = src.to(cuda), tgt.to(cuda), count.to(cuda)
    before = nn_dense.LAUNCHES
    idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
    torch.cuda.synchronize()
    assert nn_dense.LAUNCHES == before + 1
    ref_idx, ref_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, count)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(dist, ref_dist)
    for p, c in enumerate(counts):
        if c == 0:
            assert torch.all(idx[p] == 0)
            assert torch.all(dist[p] == nn_dense.BIG)


def test_kernel_planted_ties(rng, cuda):
    src = (rng.integers(-20, 20, size=(200, 3)) * 4).astype(np.float32)
    tgt = np.concatenate([src - [1, 0, 0], src + [1, 0, 0]]).astype(np.float32)
    s, t = torch.from_numpy(src).to(cuda), torch.from_numpy(tgt).to(cuda)
    count = torch.tensor(len(tgt), dtype=torch.int32, device=cuda)
    idx, dist = nearest_neighbors(s, t, count)
    ref_idx, ref_dist = nearest_neighbors_ref(s, t, count)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(dist, ref_dist)
    assert torch.all(idx < 200) and torch.all(dist == 1.0)


def test_kernel_rejects_non_contiguous(cuda):
    src = torch.zeros((1, 8, 6), device=cuda)[..., ::2]
    count = torch.tensor([8], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        nn_dense.nearest_neighbors_dense_batch(src, src.contiguous(), count)


def _k1_case(rng, name):
    """The inputs of one of ``chip_smoke.py``'s phase-3 cases of K1, and
    whether it is held to the plain version under K1's contract."""
    def box(*shape):
        return torch.from_numpy((rng.random(shape) * 10).astype(np.float32))

    if name == "8192^2":
        return box(1, 8192, 3), box(1, 8192, 3), [8192], False
    if name == "16 x 2048 ragged":
        return box(16, 2048, 3), box(16, 2048, 3), [
            2048, 2047, 1500, 1, 0, 33, 257, 1024, 2000, 999, 2048, 7, 1800, 31, 32, 1283], False
    if name == "count inside a split and a stage":
        return box(1, 20_000, 3), box(1, 102_400, 3), [50_001], False
    if name == "ties across splits":
        lattice = (rng.integers(-40, 40, size=(8192, 3)) * 4).astype(np.float32)
        ties = np.concatenate([lattice + [1, 0, 0], lattice - [1, 0, 0],
                               lattice + [1, 0, 0]]).astype(np.float32)
        return torch.from_numpy(lattice)[None], torch.from_numpy(ties)[None], [len(ties)], False
    src = (rng.random((4096, 3)) * 10).astype(np.float32)
    src[3], src[7, 1], src[11], src[13, 2], src[17] = np.nan, np.nan, np.inf, -np.inf, 1e30
    tgt = (rng.random((8192, 3)) * 10).astype(np.float32)
    tgt[5], tgt[9, 0], tgt[4000:4040], tgt[8000:] = np.inf, np.nan, np.nan, np.nan
    return torch.from_numpy(src)[None], torch.from_numpy(tgt)[None], [8000], True


@pytest.mark.parametrize("name", ["8192^2", "16 x 2048 ragged", "count inside a split and a stage",
                                  "ties across splits", "NaN and inf rows"])
def test_kernel_phase3_cases_bit_identical_to_plain(rng, cuda, name):
    """Tolerance 0 on every split geometry phase 3 reaches; NaN and inf
    rows against the plain version under K1's contract (argmin would take
    a NaN)."""
    src, tgt, counts, contract = _k1_case(rng, name)
    count = torch.tensor(counts, dtype=torch.int32, device=cuda)
    src, tgt = src.to(cuda), tgt.to(cuda)
    before = nn_dense.LAUNCHES
    idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
    torch.cuda.synchronize()
    assert nn_dense.LAUNCHES == before + 1
    plain = nn_dense.plain_under_contract if contract else nn_dense.nearest_neighbors_dense_ref
    ref_idx, ref_dist = plain(src, tgt, count)
    assert torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)
    if name == "ties across splits":
        assert nn_dense.dense_geometry(1, 8192, tgt.shape[1]).splits > 1
        assert bool((idx < 8192).all()) and bool((dist == 1.0).all())


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("stage", [32, 256])
def test_kernel_every_split_and_stage(rng, cuda, monkeypatch, splits, stage):
    """K1 bit-identical to its plain version whatever the geometry: every
    number of splits, a ring of one segment a stage, four and two
    sources a thread, a count inside a segment."""
    monkeypatch.setattr(nn_dense, "MIN_SPLIT_ROWS", 32)
    monkeypatch.setattr(nn_dense, "STAGE_ROWS", stage)
    for n, m, c in ((4096, 8192, 8192), (1000, 3000, 2999), (70_000, 4096, 4001)):
        rpt = nn_dense.dense_geometry(1, n, m).rows_per_thread
        monkeypatch.setattr(nn_dense, "BLOCKS_TARGET", splits * -(-n // (128 * rpt)))
        geo = nn_dense.dense_geometry(1, n, m)
        src = torch.from_numpy((rng.random((1, n, 3)) * 10).astype(np.float32)).to(cuda)
        tgt = torch.from_numpy((rng.random((1, m, 3)) * 10).astype(np.float32)).to(cuda)
        count = torch.tensor([c], dtype=torch.int32, device=cuda)
        idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
        ref_idx, ref_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, count)
        assert geo.splits == splits and geo.stage_rows == stage
        assert torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)


@pytest.mark.parametrize("bad", [dict(smem_bytes=1), dict(rows_per_thread=3), dict(splits=9),
                                 dict(stage_rows=48), dict(threads=256), dict(depth=4)])
def test_kernel_refused_geometry_raises(cuda, monkeypatch, bad):
    """A geometry the C entry point does not take is refused there, and
    the wrapper raises; nothing counts as launched."""
    real = nn_dense.dense_geometry
    monkeypatch.setattr(nn_dense, "dense_geometry", lambda *a: real(*a)._replace(**bad))
    src = torch.zeros((1, 64, 3), device=cuda)
    count = torch.tensor([64], dtype=torch.int32, device=cuda)
    before = nn_dense.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        nn_dense.nearest_neighbors_dense_batch(src, src, count)
    assert nn_dense.LAUNCHES == before


def test_fgt_expansions_bit_equal_across_calls(rng, cuda):
    """The FGT's segment sums add in an order the data fixes: two calls on
    the same inputs give the same bits (expansions and E-step)."""
    from tpuslam_torch.algorithms.cpd import cpd_estep_fgt
    from tpuslam_torch.ops import fgt

    n = 60_000
    pts = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(cuda)
    other = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(cuda)
    mask = torch.ones(n, device=cuda)
    w = torch.from_numpy(rng.random((n, 4)).astype(np.float32)).to(cuda)
    sigma = torch.tensor(2.0, device=cuda)
    a = fgt.compute_fgt_model_multi(pts, w, mask, sigma, 128, 8)
    b = fgt.compute_fgt_model_multi(pts, w, mask, sigma, 128, 8)
    assert torch.equal(a.ak, b.ak) and torch.equal(a.centers, b.centers)
    cnt = torch.sum(mask)
    s2 = torch.tensor(3.0, device=cuda)
    e1, e2 = (cpd_estep_fgt(pts, mask, other, mask, s2, torch.tensor(0.1, device=cuda), cnt,
                            cnt, 128, 8, 10.0, sigma2_init=s2) for _ in range(2))
    for f in ("p1", "pt1", "px", "error"):
        assert torch.equal(getattr(e1, f), getattr(e2, f)), f


def test_register_on_card_launches_k1_and_matches_cpu(rng, cuda):
    n = 8000  # padded to 8,064 target rows: below the hierarchical gate
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 1.0)
    after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
    kw = dict(max_iterations=50, max_distance_squared=1e4,
              convergence_epsilon=1e-5)
    launches = nn_dense.LAUNCHES
    on_card = tpuslam_torch.register(before, after, device=cuda, **kw)
    assert nn_dense.LAUNCHES > launches
    on_cpu = tpuslam_torch.register(before, after, device="cpu", **kw)
    assert on_card[2] == on_cpu[2]
    np.testing.assert_allclose(on_card[0], on_cpu[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card[1], on_cpu[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card[0], r, atol=1e-3)


def _hier_problem(rng, device, n=4096, m=8192, count=8000, noise=0.02):
    """Sorted sources moved a little from a warm state, the prepared
    target and the bound operands, on ``device``."""
    src = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32))
    mask = torch.ones(n)
    mask[-100:] = 0.0
    src = src[morton_permutation(src, torch.ones(n)).long()].contiguous()
    cloud = pad_cloud((rng.random((count, 3)) * 10).astype(np.float32), multiple=m,
                      device="cpu")
    target = nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count)
    idx, _ = nearest_neighbors_ref(src, cloud.points, cloud.count)
    state = nn_hier.HierState(cloud.points[idx.long()], torch.tensor(True),
                              torch.tensor(False))
    moved = src + torch.from_numpy(
        (rng.standard_normal(src.shape) * noise).astype(np.float32))
    to = lambda x: x.to(device)  # noqa: E731
    target = nn_hier.HierTarget(*map(to, target))
    state = nn_hier.HierState(*map(to, state))
    cloud = cloud._replace(points=to(cloud.points), count=to(cloud.count))
    return to(moved), to(mask), target, state, cloud


@pytest.mark.parametrize("warm,gsrc", [(False, 1024), (True, 1024), (True, 256)])
def test_bound_kernel_admits_as_plain(rng, cuda, warm, gsrc):
    moved, mask, target, state, _ = _hier_problem(rng, cuda)
    state = state._replace(warm=torch.tensor(warm, device=cuda))
    saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
    before = bound.LAUNCHES
    adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, gsrc)
    torch.cuda.synchronize()
    assert bound.LAUNCHES == before + 1
    ref = bound.bound_pass_ref(saug[None], aux[None], target.caug[None],
                               target.radii[None], eps[None], state.warm[None], gsrc)[0]
    assert torch.equal(adm, ref)
    # a batch of two: the same pair and the same pair cold
    pair = lambda x: torch.stack([x, x])  # noqa: E731
    warm2 = torch.tensor([warm, False], device=cuda)
    adm2 = bound.bound_pass_batch(pair(saug), pair(aux), pair(target.caug),
                                  pair(target.radii), pair(eps), warm2, gsrc)
    ref2 = bound.bound_pass_ref(pair(saug), pair(aux), pair(target.caug),
                                pair(target.radii), pair(eps), warm2, gsrc)
    assert torch.equal(adm2, ref2) and torch.equal(adm2[0], adm)


@pytest.mark.parametrize("arm", ["fine", "coarse"])
def test_cand_kernel_bit_identical_to_plain(rng, cuda, arm):
    moved, mask, target, state, _ = _hier_problem(rng, cuda)
    saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
    adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, 1024)
    g = 128 if arm == "fine" else 512
    if arm == "coarse":
        adm = nn_hier.coarse_admission(adm, 128, g)
    counts = adm.sum(1, dtype=torch.int32)
    width = nn_hier.table_width(8192, g, 8192)
    cand = nn_hier._build_cand_table(adm, counts, width)
    ragged = counts.clone()
    ragged[0] = 0  # one group with no live slot
    ragged[1] = counts[1] // 2
    before = nn_cand.LAUNCHES
    for c in (counts, ragged):
        idx, dist = nn_cand.nearest_neighbors_cand(
            moved, target.packed, cand, c, g=g, gsrc=1024)
        ref_idx, ref_dist = nn_cand.nearest_neighbors_cand_ref(
            moved[None], target.packed[None], cand[None], c[None], g, 1024)
        torch.cuda.synchronize()
        assert torch.equal(idx, ref_idx[0]) and torch.equal(dist, ref_dist[0])
    assert nn_cand.LAUNCHES == before + 2
    assert bool((dist[:1024] == nn_cand.BIG).all())
    pair = lambda x: torch.stack([x, x])  # noqa: E731
    b_idx, b_dist = nn_cand.nearest_neighbors_cand_batch(
        pair(moved), pair(target.packed), pair(cand),
        torch.stack([counts, ragged]), g, 1024)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        pair(moved), pair(target.packed), pair(cand),
        torch.stack([counts, ragged]), g, 1024)
    assert torch.equal(b_idx, r_idx) and torch.equal(b_dist, r_dist)


def _bound_problem(rng, cuda, n, m, count, warm):
    """K2's operands on the card for ``n`` sorted sources against a
    prepared target of ``m`` rows (``count`` valid), cold or warm, and
    the sorted-target tile of each valid source's true nearest
    neighbour."""
    src = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32))
    src = src[morton_permutation(src, torch.ones(n)).long()].contiguous()
    mask = torch.ones(n)
    mask[-(n // 50):] = 0.0
    cloud = pad_cloud((rng.random((count, 3)) * 10).astype(np.float32), multiple=m,
                      device="cpu")
    target = nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count)
    idx, _ = nearest_neighbors_ref(src, cloud.points, cloud.count)
    state = nn_hier.HierState(cloud.points[idx.long()], torch.tensor(warm),
                              torch.tensor(False))
    moved = src + torch.from_numpy((rng.standard_normal(src.shape) * 0.02).astype(np.float32))
    t_idx, _ = nearest_neighbors_ref(moved, cloud.points, cloud.count)
    inv = torch.empty(m, dtype=torch.long)
    real = target.packed[:, 3] < 1e30
    inv[target.packed[real, 3].long()] = torch.arange(m)[real]
    true_tile = inv[t_idx.long()] // 128
    to = lambda x: x.to(cuda)  # noqa: E731
    target = nn_hier.HierTarget(*map(to, target))
    state = nn_hier.HierState(*map(to, state))
    return to(moved), to(mask), target, state, to(true_tile)


@pytest.mark.parametrize("n,gsrc,m,count", [
    (4096, 256, 8192, 8000),
    (4096, 512, 8192, 8000),
    (4096, 1024, 8192, 8000),
    (3000, 3000, 8192, 8000),  # one ragged group (n < the default gsrc)
    (4096, 1024, 41_088, 40_000),  # C = 321 tiles: no multiple of a stage
    (4096, 4096, 41_088, 40_000),  # one cluster of 8 chunks: two stages
])
@pytest.mark.parametrize("warm", [False, True])
def test_bound_kernel_group_sizes(rng, cuda, n, gsrc, m, count, warm):
    """K2 admits exactly what its plain version admits, and every valid
    source's true tile, at every group size and tile count."""
    moved, mask, target, state, true_tile = _bound_problem(rng, cuda, n, m, count, warm)
    saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
    adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, gsrc)
    ref = bound.bound_pass_ref(saug[None], aux[None], target.caug[None],
                               target.radii[None], eps[None], state.warm[None], gsrc)[0]
    torch.cuda.synchronize()
    assert torch.equal(adm, ref)
    valid = mask > 0
    groups = torch.arange(n, device=cuda) // gsrc
    assert bool(adm[groups[valid], true_tile[valid]].all())
    if warm:
        assert int(adm.sum(1).max()) < m // 128  # the warm bound prunes


def _cand_case(rng, cuda, g, n=4096, gsrc=1024, m=8192):
    """A packed target of ``m`` random rows (the last 200 sentinels) and a
    table of random tile ids per group, with ragged counts (one group
    empty) and one id out of range."""
    pts = (rng.random((m, 3)) * 10).astype(np.float32)
    w = rng.permutation(m).astype(np.float32)
    pts[-200:], w[-200:] = 1e19, nn_cand.BIG
    packed = torch.from_numpy(np.concatenate([pts, w[:, None]], 1)).to(cuda)
    src = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(cuda)
    ts, tiles = n // gsrc, m // g
    width = min(tiles, 24)
    cand = torch.from_numpy(np.stack([rng.permutation(tiles)[:width] for _ in range(ts)])
                            .astype(np.int32)).to(cuda)
    cand[-1, 0] = tiles + 5  # skipped
    counts = torch.from_numpy(rng.integers(1, width + 1, size=ts).astype(np.int32)).to(cuda)
    counts[0] = 0
    return src, packed, cand, counts


@pytest.mark.parametrize("g", [128, 256, 512, 1024])
def test_cand_kernel_tile_sizes_and_slot_order(rng, cuda, g):
    """K3 bit-identical to its plain version at every tile size; a group's
    live slots permuted give the same bits; an empty group gives
    (0, 3.4e38); a batch of two equals its pairs."""
    src, packed, cand, counts = _cand_case(rng, cuda, g)
    idx, dist = nn_cand.nearest_neighbors_cand(src, packed, cand, counts, g=g, gsrc=1024)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        src[None], packed[None], cand[None], counts[None], g, 1024)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx[0]) and torch.equal(dist, r_dist[0])
    assert bool((idx[:1024] == 0).all()) and bool((dist[:1024] == nn_cand.BIG).all())
    perm = cand.clone()
    for grp, c in enumerate(counts.tolist()):
        perm[grp, :c] = cand[grp, torch.randperm(c, device=cuda)]
    p_idx, p_dist = nn_cand.nearest_neighbors_cand(src, packed, perm, counts, g=g, gsrc=1024)
    torch.cuda.synchronize()
    assert torch.equal(p_idx, idx) and torch.equal(p_dist, dist)
    pair = lambda x, y: torch.stack([x, y])  # noqa: E731
    b_idx, b_dist = nn_cand.nearest_neighbors_cand_batch(
        pair(src, src), pair(packed, packed), pair(cand, perm),
        pair(counts, counts.flip(0)), g, 1024)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        pair(src, src), pair(packed, packed), pair(cand, perm),
        pair(counts, counts.flip(0)), g, 1024)
    assert torch.equal(b_idx, r_idx) and torch.equal(b_dist, r_dist)
    assert torch.equal(b_idx[0], idx) and torch.equal(b_dist[0], dist)


def test_cand_kernel_planted_ties_across_blocks(rng, cuda):
    """Every target point twice, once in the first half of the tiles with
    the higher original index and once in the second half with the lower:
    the split hands the two copies to different blocks of the cluster, and
    the lower index must win."""
    g, m, n = 128, 8192, 2048
    pts = (rng.integers(-40, 40, size=(m // 2, 3)) * 4).astype(np.float32)
    low = rng.permutation(m // 2).astype(np.float32)
    rows = np.concatenate([np.concatenate([pts, (low + m // 2)[:, None]], 1),
                           np.concatenate([pts, low[:, None]], 1)])
    packed = torch.from_numpy(rows.astype(np.float32)).to(cuda)
    src = torch.from_numpy(pts[rng.integers(0, m // 2, size=n)] + 1.0).to(cuda)
    tiles = m // g
    cand = torch.arange(tiles, dtype=torch.int32, device=cuda).repeat(2, 1)
    counts = torch.full((2,), tiles, dtype=torch.int32, device=cuda)
    assert nn_cand.cand_geometry(1, 2, tiles, 1024).splits > 1
    idx, dist = nn_cand.nearest_neighbors_cand(src, packed, cand, counts, g=g, gsrc=1024)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        src[None], packed[None], cand[None], counts[None], g, 1024)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx[0]) and torch.equal(dist, r_dist[0])
    assert bool((idx < m // 2).all())


@pytest.mark.parametrize("n", [700, 1500])
def test_cand_kernel_ragged_group(rng, cuda, n):
    """One group of ``n`` sources (n < 1,024, and past one block of 512)."""
    src, packed, cand, counts = _cand_case(rng, cuda, 128, n=n, gsrc=n)
    counts[0] = 17
    idx, dist = nn_cand.nearest_neighbors_cand(src, packed, cand, counts, g=128, gsrc=n)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        src[None], packed[None], cand[None], counts[None], 128, n)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx[0]) and torch.equal(dist, r_dist[0])


def test_hier_search_bit_identical_to_k1(rng, cuda):
    moved, mask, target, state, cloud = _hier_problem(rng, cuda)
    k = (bound.LAUNCHES, nn_cand.LAUNCHES)
    idx, dist, new_state = nn_hier.nearest_neighbors_hier(
        moved, mask, target, state)
    k1_idx, k1_dist = nearest_neighbors(moved, cloud.points, cloud.count)
    torch.cuda.synchronize()
    assert nn_hier.ARM_TRACE[-1] == "fine" and bool(new_state.sparse)
    assert (bound.LAUNCHES, nn_cand.LAUNCHES) == (k[0] + 1, k[1] + 1)
    valid = mask > 0
    assert torch.equal(idx[valid], k1_idx[valid])
    assert torch.equal(dist[valid], k1_dist[valid])


def test_register_on_card_launches_hier_kernels_and_matches_cpu(rng, cuda):
    n = 12_000  # above the hierarchical gate on CUDA
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 1.0)
    after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
    kw = dict(max_iterations=50, max_distance_squared=1e4, eps=1e-5)
    k = (bound.LAUNCHES, nn_cand.LAUNCHES)
    on_card = icp_register(pad_cloud(before, device=cuda),
                           pad_cloud(after, device=cuda), **kw)
    assert bound.LAUNCHES > k[0] and nn_cand.LAUNCHES > k[1]
    on_cpu = icp_register(pad_cloud(before, device="cpu"), pad_cloud(after, device="cpu"),
                          use_spatial=True, **kw)
    assert on_card.iterations == on_cpu.iterations
    for a, b in ((on_card.transform.rotation, on_cpu.transform.rotation),
                 (on_card.transform.translation, on_cpu.transform.translation)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(), r, atol=1e-3)


def _sorted_cloud(rng, n, device, spread=10.0):
    p = torch.from_numpy((rng.random((n, 3)) * spread).astype(np.float32))
    return p[morton_permutation(p, torch.ones(n)).long()].contiguous().to(device)


def test_cpd_dense_kernel_matches_plain(rng, cuda):
    """K4's two passes against their plain versions: a batch of two with
    ragged masks, one pair truncated."""
    mov = torch.stack([_sorted_cloud(rng, 3072, cuda) for _ in range(2)])
    tgt = torch.stack([_sorted_cloud(rng, 2048, cuda) for _ in range(2)])
    mm = torch.ones(2, 3072, device=cuda)
    mm[1, 2500:] = 0
    tm = torch.ones(2, 2048, device=cuda)
    tm[0, 1700:] = 0
    ty = torch.where(mm[:, :, None] > 0, mov, cpd_dense.SENTINEL).contiguous()
    scalars = cpd_dense.estep_scalars(torch.tensor([0.5, 0.05], device=cuda),
                                      torch.tensor([0.3, 0.01], device=cuda),
                                      torch.tensor([False, True], device=cuda), 1e-3)
    k = (cpd_dense.DENOM_LAUNCHES, cpd_dense.MOMENTS_LAUNCHES)
    denom = cpd_dense.denom_pass_batch(scalars, ty, tgt)
    ref = cpd_dense.denom_pass_ref(scalars, ty, tgt)
    torch.testing.assert_close(denom, ref, rtol=1e-5, atol=0)
    _, w4 = cpd_dense.moment_weights(ref[:, 0], tgt, tm, scalars[:, 1])
    acc = cpd_dense.moments_pass_batch(scalars, ty, tgt, w4)
    acc_ref = cpd_dense.moments_pass_ref(scalars, ty, tgt, w4)
    torch.cuda.synchronize()
    assert (cpd_dense.DENOM_LAUNCHES, cpd_dense.MOMENTS_LAUNCHES) == (k[0] + 1, k[1] + 1)
    torch.testing.assert_close(acc, acc_ref, rtol=1e-5, atol=1e-6)
    assert torch.all(acc[1, :, 2500:] == 0)  # sentinel rows gather nothing


def _cluster_cloud(rng, device):
    centers = np.array([[0, 0, 0], [100, 0, 0], [0, 100, 0], [0, 0, 100]], np.float32)
    pts = np.concatenate([(rng.random((1024, 3)) * 3).astype(np.float32) + c
                          for c in centers])
    p = torch.from_numpy(pts)
    return p[morton_permutation(p, torch.ones(4096)).long()].contiguous().to(device)


@pytest.mark.parametrize("fixture,s2,trunc", [
    ("uniform", 4.0, False),  # wide: full admission (the table still fits)
    ("uniform", 0.05, True),  # the Hybrid window
    ("clusters", 0.05, True),  # tight: only each cluster's own block
    ("clusters", 0.05, False),  # exact mode
])
def test_cpd_cand_kernel_bit_identical_to_dense(rng, cuda, fixture, s2, trunc):
    if fixture == "uniform":
        mov, tgt = _sorted_cloud(rng, 4096, cuda), _sorted_cloud(rng, 4096, cuda)
    else:
        mov = _cluster_cloud(rng, cuda)
        tgt = (mov + 0.01)[torch.randperm(4096, device=cuda)]
        tgt = tgt[morton_permutation(tgt, torch.ones(4096, device=cuda)).long()].contiguous()
    ones = torch.ones(4096, device=cuda)
    args = (mov, ones, tgt, ones, s2, 0.3)
    k = cpd_cand.DENOM_LAUNCHES
    cand, ovf = cpd_cand.cpd_estep_cand(*args, torch.tensor(trunc, device=cuda),
                                        checked=True)
    dense = cpd_dense.cpd_estep_dense(*args, trunc)
    torch.cuda.synchronize()
    assert not bool(ovf) and cpd_cand.DENOM_LAUNCHES == k + 1
    for f in ("p1", "pt1", "px", "error"):
        assert torch.equal(getattr(cand, f), getattr(dense, f)), f


def test_cpd_wrappers_reject_mixed_devices(cuda):
    ty = torch.zeros(1, 1024, 3, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        cpd_dense.denom_pass_batch(torch.zeros(1, 4), ty, ty)
    ctas = 1024 // cpd_dense.cpd_geometry(1024).cta_rows
    table = torch.zeros(ctas, 8, dtype=torch.int32, device=cuda)
    counts = torch.zeros(ctas, dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        cpd_cand.denom_cand(torch.zeros(4, device=cuda), ty[0], ty[0], table, counts)


def _k5_against_k4(mov, tgt, s2, trunc, c=0.3):
    """K5's E-step (checked, must not overflow) against K4's, bit for bit;
    returns the admission and the share of pairs K5's passes visit."""
    dev = mov.device
    ones_m = torch.ones(len(mov), device=dev)
    ones_t = torch.ones(len(tgt), device=dev)
    args = (mov, ones_m, tgt, ones_t, s2, c)
    cand, ovf = cpd_cand.cpd_estep_cand(*args, torch.tensor(trunc, device=dev), checked=True)
    dense = cpd_dense.cpd_estep_dense(*args, trunc)
    torch.cuda.synchronize()
    assert not bool(ovf)
    for f in ("p1", "pt1", "px", "error"):
        assert torch.equal(getattr(cand, f), getattr(dense, f)), f
    adm = cpd_cand.block_admission(mov, ones_m, tgt, ones_t, torch.tensor(s2, device=dev),
                                   torch.tensor(trunc, device=dev))
    geo = cpd_dense.cpd_geometry(len(tgt))
    table, counts = cpd_cand.cta_tables(adm.sub_adm, adm.f_sub, geo.cta_rows, ~adm.fat_n,
                                        adm.width_m)
    visited = cpd_cand.visited_pairs(table, counts, geo.cta_rows) / (len(mov) * len(tgt))
    return adm, visited


@pytest.mark.parametrize("rows_per_thread", [1, 2])
@pytest.mark.parametrize("s2,trunc", [(1.0, True), (0.05, True), (0.01, True), (0.002, True)])
def test_cpd_cand_segments_bit_identical_to_dense(rng, cuda, monkeypatch, s2, trunc,
                                                  rows_per_thread):
    """Uniform boxes of 8 blocks a side at four sigma^2: K5 skipping 128-row
    segments inside admitted blocks equals K4 bit for bit, at either
    number of rows a thread; at the tight settings it visits fewer pairs
    than it admits block pairs."""
    if rows_per_thread == 2:
        monkeypatch.setattr(cpd_dense, "FILL_THREADS", 0)
    assert cpd_dense.cpd_geometry(8192).rows_per_thread == rows_per_thread
    mov, tgt = _sorted_cloud(rng, 8192, cuda), _sorted_cloud(rng, 8192, cuda)
    adm, visited = _k5_against_k4(mov, tgt, s2, trunc)
    if s2 <= 0.01:
        assert visited < float(adm.adm.float().mean())


def test_cpd_cand_segments_clusters_with_fat_blocks(rng, cuda, monkeypatch):
    """20 clusters of 1,024 points 100 apart, one a block, with one block a
    side refilled from every cluster: fat blocks served by K4's passes,
    everything else by K5's segment walk."""
    monkeypatch.setattr(cpd_cand, "SLOTS", 1)
    grid = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(3)][:20],
                    np.float32) * 100.0
    pts = np.concatenate([(rng.random((1024, 3)) * 3).astype(np.float32) + g for g in grid])
    mov, tgt = pts.copy(), (pts + 0.01).astype(np.float32)
    mov[3 * 1024:4 * 1024] = pts[rng.permutation(len(pts))[:1024]]
    tgt[7 * 1024:8 * 1024] = tgt[rng.permutation(len(pts))[:1024]]
    adm, _ = _k5_against_k4(torch.from_numpy(mov).to(cuda), torch.from_numpy(tgt).to(cuda),
                            0.05, True)
    assert bool(adm.fat_n.any()) and bool(adm.fat_m.any())


@pytest.mark.parametrize("s2", [0.05, 0.002])
def test_cpd_cand_segments_planted_at_the_cutoff(rng, cuda, s2):
    """Pairs planted just inside and just outside the truncation distance
    across segment boundaries: the admission margins keep every kept term,
    and K5 equals K4 bit for bit."""
    mov = _sorted_cloud(rng, 8192, cuda)
    cut = float(np.sqrt(-2.0 * np.log(1e-3) * s2))
    tgt = mov.clone()
    step = torch.zeros(3, device=cuda)
    step[0] = 1.0
    # every 37th target point sits at the cutoff distance from its moving
    # twin, alternately 1e-6 inside and outside it; the rest 0.3 of it away
    idx = torch.arange(0, 8192, 37, device=cuda)
    sign = (torch.arange(len(idx), device=cuda) % 2) * 2 - 1
    tgt = tgt + 0.3 * cut
    tgt[idx] = mov[idx] + step * (cut * (1 + 1e-6 * sign))[:, None]
    tgt = tgt[morton_permutation(tgt, torch.ones(8192, device=cuda)).long()].contiguous()
    _k5_against_k4(mov, tgt, s2, True)


@pytest.mark.parametrize("rows_per_thread", [1, 2])
def test_cpd_dense_register_tiled_matches_plain(rng, cuda, monkeypatch, rows_per_thread):
    """K4 at 1 and 2 rows a thread against its plain version: a batch of
    two with ragged masks, one pair truncated and one not; both geometries
    give the same bits (the order does not depend on them)."""
    mov = torch.stack([_sorted_cloud(rng, 4096, cuda) for _ in range(2)])
    tgt = torch.stack([_sorted_cloud(rng, 5120, cuda) for _ in range(2)])
    mm = torch.ones(2, 4096, device=cuda)
    mm[1, 3000:] = 0
    tm = torch.ones(2, 5120, device=cuda)
    tm[0, 4500:] = 0
    ty = torch.where(mm[:, :, None] > 0, mov, cpd_dense.SENTINEL).contiguous()
    scalars = cpd_dense.estep_scalars(torch.tensor([0.3, 0.02], device=cuda),
                                      torch.tensor([0.3, 0.01], device=cuda),
                                      torch.tensor([False, True], device=cuda), 1e-3)
    denom1 = cpd_dense.denom_pass_batch(scalars, ty, tgt)
    ref = cpd_dense.denom_pass_ref(scalars, ty, tgt)
    _, w4 = cpd_dense.moment_weights(ref[:, 0], tgt, tm, scalars[:, 1])
    acc1 = cpd_dense.moments_pass_batch(scalars, ty, tgt, w4)
    if rows_per_thread == 2:
        monkeypatch.setattr(cpd_dense, "FILL_THREADS", 0)
    assert cpd_dense.cpd_geometry(4096, 2).rows_per_thread == rows_per_thread
    denom = cpd_dense.denom_pass_batch(scalars, ty, tgt)
    acc = cpd_dense.moments_pass_batch(scalars, ty, tgt, w4)
    acc_ref = cpd_dense.moments_pass_ref(scalars, ty, tgt, w4)
    torch.cuda.synchronize()
    torch.testing.assert_close(denom, ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(acc, acc_ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(denom, denom1) and torch.equal(acc, acc1)
    assert torch.all(acc[1, :, 3000:] == 0)  # sentinel rows gather nothing


@pytest.mark.parametrize("c,shift", [(1e-20, 7.5), (0.0, 9.0)])
def test_cpd_dense_all_underflow_row(cuda, c, shift):
    """A target row whose every term underflows: at distance 7.5 (sigma^2
    = 0.3) every exponent lies in (-103, -87), where expf gives a
    subnormal and the kernel's ex2.approx.ftz gives +0: with c = 1e-20 the
    denominators agree (both c); at 9.0 every term is below e^-104 and
    zero on both sides, so with c = 0 both denominators are exactly 0."""
    rng = np.random.default_rng(5)
    mov = torch.from_numpy((rng.random((1024, 3)) * 0.01).astype(np.float32)).to(cuda)
    tgt = torch.from_numpy((rng.random((1024, 3)) * 0.01).astype(np.float32)).to(cuda)
    tgt[100:200, 0] += shift  # the far rows
    scalars = cpd_dense.estep_scalars(torch.tensor([0.3], device=cuda),
                                      torch.tensor([c], device=cuda),
                                      torch.tensor([False], device=cuda), 1e-3)
    denom = cpd_dense.denom_pass_batch(scalars, mov[None], tgt[None])[0, 0]
    ref = cpd_dense.denom_pass_ref(scalars, mov[None], tgt[None])[0, 0]
    torch.cuda.synchronize()
    far = slice(100, 200)
    assert bool((denom[far] == c).all())
    if c == 0.0:
        assert bool((ref[far] == 0).all())
    else:
        torch.testing.assert_close(denom[far], ref[far], rtol=1e-5, atol=0)
    torch.testing.assert_close(denom[:100], ref[:100], rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", [ApproximationType.NONE, ApproximationType.Hybrid])
def test_cpd_register_on_card_matches_cpu(rng, cuda, mode):
    n = 3000
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.1)
    t = get_random_translation_vector(rng, 0.5)
    after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
    kw = dict(weight=0.1, max_iterations=100, tolerance=1e-5, use_fgt=False,
              approximation_type=mode, use_kernels=True)
    k = cpd_dense.DENOM_LAUNCHES + cpd_cand.DENOM_LAUNCHES
    on_card = cpd_register(pad_cloud(before, device=cuda), pad_cloud(after, device=cuda), **kw)
    assert cpd_dense.DENOM_LAUNCHES + cpd_cand.DENOM_LAUNCHES > k
    on_cpu = cpd_register(pad_cloud(before, device="cpu"), pad_cloud(after, device="cpu"), **kw)
    assert on_card.iterations == on_cpu.iterations
    for a, b in ((on_card.transform.rotation, on_cpu.transform.rotation),
                 (on_card.transform.translation, on_cpu.transform.translation)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(), r, atol=1e-3)


# --- NICP, prealigned ICP and batching (slice 7) ------------------------------

@pytest.mark.parametrize("rows,m", [(8 * 1024, 1_048_576), (248 * 1024, 102_400)])
def test_kernel_at_nicp_rescore_shapes(rng, cuda, rows, m):
    """K1 at NICP's rescore shapes (8 candidates, and 248 when both axes
    are widened, x 1,024 subcloud rows) bit for bit with its plain
    version."""
    src = torch.from_numpy((rng.random((1, rows, 3)) * 10).astype(np.float32)).to(cuda)
    tgt = torch.from_numpy((rng.random((1, m, 3)) * 10).astype(np.float32)).to(cuda)
    count = torch.tensor([m], dtype=torch.int32, device=cuda)
    idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
    r_idx, r_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, count, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx) and torch.equal(dist, r_dist)


def _stacked_hier_problem(rng, cuda, b, n, far=None):
    """``b`` pairs of ``n`` sorted sources near a warm state against their
    own prepared targets of ``n`` rows; pair ``far`` (if any) moved far
    enough to overflow every budget."""
    targets, states, moved, masks = [], [], [], []
    for k in range(b):
        cloud = pad_cloud((rng.random((n - 50, 3)) * 10).astype(np.float32), multiple=n,
                          device=cuda)
        target = nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count)
        src = _sorted_cloud(rng, n, cuda)
        idx, _ = nearest_neighbors(src, cloud.points, cloud.count)
        states.append(nn_hier.HierState(cloud.points[idx.long()],
                                        torch.tensor(True, device=cuda),
                                        torch.tensor(False, device=cuda)))
        step = 3.0 if k == far else 0.02
        moved.append(src + torch.from_numpy(
            (rng.standard_normal((n, 3)) * step).astype(np.float32)).to(cuda))
        masks.append((torch.arange(n, device=cuda) < n - 31 * k).float())
        targets.append(target)
    stack = lambda xs: type(xs[0])(*(torch.stack(f) for f in zip(*xs)))  # noqa: E731
    return torch.stack(moved), torch.stack(masks), stack(targets), stack(states)


@pytest.mark.parametrize("far,arm", [(None, "fine"), (5, "dense")])
def test_hier_batch_bit_identical_to_k1_batch(rng, cuda, far, arm):
    """The batched hierarchical search at 16 x 16,384 against K1's batch
    form, tolerance 0; with one pair far from its warm state the whole
    batch takes the dense arm.  Groups of 256 sources and a budget of 96
    of the 128 tiles: a group near its warm state admits at most ~60, the
    far pair's all 128 (and all 16 coarse tiles, over their budget 10)."""
    moved, masks, target, state = _stacked_hier_problem(rng, cuda, 16, 16_384, far)
    k = (bound.BATCH_LAUNCHES[16], nn_cand.BATCH_LAUNCHES[16])
    idx, dist, new = nn_hier.nearest_neighbors_hier_batch(moved, masks, target, state,
                                                         l_budget=96, gsrc=256)
    k1_idx, k1_dist = nn_dense.nearest_neighbors_dense_batch(
        moved, target.original_points, target.count)
    torch.cuda.synchronize()
    assert nn_hier.ARM_TRACE[-1] == arm
    assert bound.BATCH_LAUNCHES[16] == k[0] + 1
    assert nn_cand.BATCH_LAUNCHES[16] == k[1] + (arm != "dense")
    valid = masks > 0
    assert torch.equal(idx[valid], k1_idx[valid]) and torch.equal(dist[valid], k1_dist[valid])
    assert new.sparse.tolist() == [arm != "dense"] * 16


@pytest.mark.parametrize("mode", [ApproximationType.NONE, ApproximationType.Full])
def test_nicp_on_card_matches_cpu(rng, cuda, mode):
    from tpuslam_torch.algorithms.nicp import nicp_register

    n = 20_000
    before = (rng.random((n, 3)) * np.array([40.0, 20.0, 10.0])).astype(np.float32)
    r = get_random_rotation_matrix(rng, 1.0)
    t = get_random_translation_vector(rng, 10.0)
    after = (before @ r.T + t).astype(np.float32)
    if mode == ApproximationType.NONE:
        after = after[rng.permutation(n)]
    k = nn_dense.LAUNCHES
    on_card = nicp_register(pad_cloud(before, device=cuda), pad_cloud(after, device=cuda),
                            approximation_type=mode, seed=1)
    assert nn_dense.LAUNCHES == k + 1  # one rescore call
    on_cpu = nicp_register(pad_cloud(before, device="cpu"), pad_cloud(after, device="cpu"),
                           approximation_type=mode, seed=1)
    assert on_card.iterations == on_cpu.iterations == 4
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(),
                               on_cpu.transform.rotation.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card.transform.translation.cpu().numpy(),
                               on_cpu.transform.translation.numpy(), rtol=0, atol=1e-4 * 40)
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(), r, atol=1e-3)


@pytest.mark.parametrize("use_spatial", [False, True])
def test_batched_icp_with_frozen_pairs_matches_solo(rng, cuda, use_spatial):
    """The batched ICP lowering on the card, with pairs that stop at once
    (identity, no correspondence) beside pairs that run: each pair equals
    its solo run bit for bit (the batched step sums each pair's rows by
    the solo call)."""
    from tpuslam_torch.algorithms.batch import icp_register_batch, stack_clouds
    from tpuslam_torch.core.types import Cloud

    n = 16_384
    scale = np.array([10.0, 5.0, 2.5], np.float32)
    moving = (rng.random((n, 3)) * scale).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 1.0)
    other = (rng.random((n, 3)) * scale).astype(np.float32)
    befores = [moving, moving, moving, other]
    afters = [(moving @ r.T + t).astype(np.float32), moving.copy(), moving + 1000.0,
              (other @ r.T + t).astype(np.float32)]
    bb, ba = stack_clouds(befores, device=cuda), stack_clouds(afters, device=cuda)
    kw = dict(eps=1e-5, max_distance_squared=50.0, max_iterations=40, use_spatial=use_spatial)
    k = nn_dense.BATCH_LAUNCHES[4] + bound.BATCH_LAUNCHES[4]
    out = icp_register_batch(bb, ba, unroll=False, **kw)
    assert nn_dense.BATCH_LAUNCHES[4] + bound.BATCH_LAUNCHES[4] > k
    iters = out.iterations.tolist()
    assert iters[1] == 0 and iters[2] == 0 and max(iters) > 2
    for p in range(4):
        solo = icp_register(Cloud(bb.points[p], bb.count[p]), Cloud(ba.points[p], ba.count[p]),
                            **kw)
        assert iters[p] == solo.iterations
        assert torch.equal(out.transform.rotation[p], solo.transform.rotation)
        assert torch.equal(out.transform.translation[p], solo.transform.translation)
        assert torch.equal(out.error[p], solo.error)


def test_register_pairs_and_prealign_on_card(rng, cuda):
    """``register_pairs`` (ICP, 16 x 2,048) launches K1's batch form with
    B = 16; prealigned ICP on the card lands within 1e-4 of the CPU run."""
    befores = [(rng.random((2048, 3)) * 10).astype(np.float32) for _ in range(16)]
    afters = []
    for b in befores:
        r = get_random_rotation_matrix(rng, 0.2)
        afters.append((b @ r.T + get_random_translation_vector(rng, 1.0)).astype(np.float32))
    k = nn_dense.BATCH_LAUNCHES[16]
    rots, _, iters, _ = tpuslam_torch.register_pairs(befores, afters, device=cuda)
    assert nn_dense.BATCH_LAUNCHES[16] > k and iters.shape == (16,)
    before = (rng.random((6000, 3)) * np.array([40.0, 20.0, 10.0])).astype(np.float32)
    r = get_random_rotation_matrix(rng, 2.0)
    after = (before @ r.T + get_random_translation_vector(rng, 30.0)).astype(np.float32)
    kw = dict(icp_prealign=True, max_iterations=60, max_distance_squared=1e9,
              convergence_epsilon=1e-6, random_seed=1)
    on_card = tpuslam_torch.register(before, after, device=cuda, **kw)
    on_cpu = tpuslam_torch.register(before, after, device="cpu", **kw)
    assert on_card[2] == on_cpu[2]
    np.testing.assert_allclose(on_card[0], on_cpu[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card[0], r, atol=1e-3)
