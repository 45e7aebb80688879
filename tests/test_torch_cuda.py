"""Kernel K1 and the ICP slice of the PyTorch port on a CUDA card.

Every test here needs a card and nvcc; without them each one skips (the
``cuda`` fixture decides, at run time).  The file imports neither JAX
nor ``tpuslam``, so it runs where JAX is not installed, without the
JAX-loading ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

On the card, K1 must be bit-identical (idx and dist) to its plain
version, and a registration must agree with the CPU run within 1e-4 in
R and t (cuSOLVER against LAPACK, sums in another order).
"""

import numpy as np
import pytest
import torch

import tpuslam_torch
from tpuslam_torch.data.synthesis import (
    get_random_rotation_matrix,
    get_random_translation_vector,
)
from tpuslam_torch.kernels import nn_dense
from tpuslam_torch.ops.nn import nearest_neighbors, nearest_neighbors_ref

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
    n = 8192
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
