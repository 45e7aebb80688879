"""The plain references recover a known pose at a tiny size, and import
nothing of the program or of JAX."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import pool as pools
from reference import cpd as ref_cpd
from reference import icp as ref_icp

REFERENCE = Path(ref_icp.__file__).parent


def _known(seed, n, angle, length):
    rng = np.random.default_rng(seed)
    cloud = rng.normal(size=(n, 3)).astype(np.float32) * np.float32([3, 2, 1])
    r = pools.get_random_rotation_matrix(rng, angle)
    t = pools.get_random_translation_vector(rng, length)
    return cloud, (cloud @ r.T + t).astype(np.float32), r, t


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_icp_recovers_a_known_pose(seed):
    before, after, r, t = _known(seed, 400, 0.2, 0.5)
    got_r, got_t, iterations, error = ref_icp.icp(before, after, eps=1e-9,
                                                  max_distance_squared=1e4, max_iterations=100)
    np.testing.assert_allclose(got_r, r, atol=1e-4)
    np.testing.assert_allclose(got_t, t, atol=1e-4)
    assert error < 1e-6 and iterations < 100


@pytest.mark.parametrize("seed", [1, 2])
def test_cpd_recovers_a_known_pose(seed):
    before, after, r, t = _known(seed, 300, 0.3, 1.0)
    for hybrid in (False, True):
        got_r, got_t, iterations, sigma2 = ref_cpd.cpd(
            before, after, weight=0.1, const_scale=True, tolerance=1e-8, eps=1e-10,
            max_iterations=200, hybrid=hybrid)
        np.testing.assert_allclose(got_r, r, atol=2e-3)
        np.testing.assert_allclose(got_t, t, atol=2e-3)
        assert sigma2 < 1e-3


def test_nearest_is_exact():
    rng = np.random.default_rng(0)
    src = torch.tensor(rng.normal(size=(70, 3)), dtype=torch.float64)
    tgt = torch.tensor(rng.normal(size=(90, 3)), dtype=torch.float64)
    idx, d2 = ref_icp.nearest(src, tgt, block_pairs=500)
    full = torch.cdist(src, tgt) ** 2
    assert torch.equal(idx, full.argmin(1))
    torch.testing.assert_close(d2, full.min(1).values)


def test_reference_imports_nothing_of_the_program():
    for f in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in {"math", "torch", "numpy", "__future__", "reference"}, (f, name)
