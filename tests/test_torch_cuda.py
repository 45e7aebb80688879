"""Kernels K1, K2 and K3 and the ICP slice of the PyTorch port on a
CUDA card.

Every test here needs a card and nvcc; without them each one skips (the
``cuda`` fixture decides, at run time).  The file imports neither JAX
nor ``tpuslam``, so it runs where JAX is not installed, without the
JAX-loading ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

On the card, K1 and K3 must be bit-identical (idx and dist) to their
plain versions, K2 must admit exactly what its plain version admits, the
hierarchical search must be bit-identical to K1, and a registration must
agree with the CPU run within 1e-4 in R and t (cuSOLVER against LAPACK,
sums in another order).
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
from tpuslam_torch.kernels import bound, nn_cand, nn_dense
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
    cloud = pad_cloud((rng.random((count, 3)) * 10).astype(np.float32), multiple=m)
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
    on_cpu = icp_register(pad_cloud(before), pad_cloud(after), use_spatial=True, **kw)
    assert on_card.iterations == on_cpu.iterations
    for a, b in ((on_card.transform.rotation, on_cpu.transform.rotation),
                 (on_card.transform.translation, on_cpu.transform.translation)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(), r, atol=1e-3)
