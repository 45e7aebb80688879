"""Geometry and Procrustes of the PyTorch port against the JAX package.

Tolerances, with their reasons:

* ``transform_points``: 4e-6 absolute at spread 10.  XLA on the CPU
  contracts each output coordinate to ``fma(z, r2, fma(x, r0, y*r1))``;
  torch eager rounds every product and sum (measured up to about 1e-6).
* masked statistics: 1e-6 relative — float32 sums taken in another order.
* ``weighted_procrustes`` / ``svd_rotation``: R and t within 1e-5 — the
  cross-covariance is a float32 sum in another order, and the SVDs are
  different LAPACK paths.  U and V are never compared (their signs are
  free); R is unique because the singular values are distinct.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import make_cloud, random_rigid
from tpuslam.core.types import RigidTransform as JaxRigid
from tpuslam.ops import geometry as jax_geometry
from tpuslam.ops import procrustes as jax_procrustes
from tpuslam_torch.core.types import RigidTransform
from tpuslam_torch.ops import geometry, procrustes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def test_matmul_precision_is_pinned_to_float32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_transform_points_matches_jax(rng):
    pts = make_cloud(rng, 1000, spread=10.0)
    r, t = random_rigid(rng, 0.7, 5.0)
    ours = geometry.transform_points(_t(pts), _t(r), _t(t)).numpy()
    ref = np.asarray(jax_geometry.transform_points(
        jnp.asarray(pts), jnp.asarray(r), jnp.asarray(t)
    ))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=4e-6)


def test_transform_points_scale(rng):
    pts = make_cloud(rng, 200)
    r, t = random_rigid(rng, 0.3, 1.0)
    ours = geometry.transform_points(_t(pts), _t(r), _t(t), 2.5).numpy()
    ref = np.asarray(jax_geometry.transform_points(
        jnp.asarray(pts), jnp.asarray(r), jnp.asarray(t), 2.5
    ))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_rigid_transform_apply_and_compose(rng):
    r1, t1 = random_rigid(rng, 0.4, 2.0)
    r2, t2 = random_rigid(rng, 0.9, 3.0)
    a = RigidTransform(_t(r1), _t(t1), torch.tensor(1.5))
    b = RigidTransform(_t(r2), _t(t2), torch.tensor(0.5))
    ja = JaxRigid(jnp.asarray(r1), jnp.asarray(t1), jnp.float32(1.5))
    jb = JaxRigid(jnp.asarray(r2), jnp.asarray(t2), jnp.float32(0.5))
    ours, ref = a.compose(b), ja.compose(jb)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
    pts = make_cloud(rng, 64)
    np.testing.assert_allclose(
        a.apply(_t(pts)).numpy(), np.asarray(ja.apply(jnp.asarray(pts))),
        atol=1e-5,
    )
    ident = RigidTransform.identity()
    assert torch.equal(ident.apply(_t(pts)), _t(pts))


def test_masked_statistics_match_jax(rng):
    pts = make_cloud(rng, 300)
    mask = (rng.random(300) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        geometry.masked_mean(_t(pts), _t(mask)).numpy(),
        np.asarray(jax_geometry.masked_mean(jnp.asarray(pts), jnp.asarray(mask))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(geometry.masked_mse(_t(pts), _t(mask))),
        float(jax_geometry.masked_mse(jnp.asarray(pts), jnp.asarray(mask))),
        rtol=1e-6,
    )
    zero = np.zeros(300, np.float32)  # empty mask: guarded divide
    assert float(geometry.masked_mse(_t(pts), _t(zero))) == 0.0


@pytest.mark.parametrize("case", ["rotation", "reflection", "masked"])
def test_weighted_procrustes_matches_jax(rng, case):
    before = make_cloud(rng, 500) - 5.0  # centred: t stays of order 1
    r, t = random_rigid(rng, 0.5, 2.0)
    after = before @ r.T + t + rng.normal(0, 0.01, (500, 3)).astype(np.float32)
    w = np.ones(500, np.float32)
    if case == "reflection":
        # mirrored data: the best orthogonal map has det -1, so the
        # determinant correction must flip the smallest singular direction
        after = after * np.array([-1, 1, 1], np.float32)
    elif case == "masked":
        w = (rng.random(500) > 0.4).astype(np.float32)
        after[w == 0] += 100.0  # dropped rows must not matter
    after = after.astype(np.float32)
    r_ours, t_ours = procrustes.weighted_procrustes(_t(before), _t(after), _t(w))
    r_ref, t_ref = jax_procrustes.weighted_procrustes(
        jnp.asarray(before), jnp.asarray(after), jnp.asarray(w)
    )
    np.testing.assert_allclose(r_ours.numpy(), np.asarray(r_ref), atol=1e-5)
    np.testing.assert_allclose(t_ours.numpy(), np.asarray(t_ref), atol=1e-5)
    assert np.linalg.det(r_ours.numpy()) == pytest.approx(1.0, abs=1e-5)
    if case == "rotation":
        np.testing.assert_allclose(r_ours.numpy(), r, atol=1e-3)


def test_svd_rotation_matches_jax(rng):
    h = rng.normal(size=(3, 3)).astype(np.float32)
    h[:, 0] *= -1 if np.linalg.det(h) > 0 else 1  # det(h) < 0: corrected
    r_ours, s_ours = procrustes.svd_rotation(_t(h))
    r_ref, s_ref = jax_procrustes.svd_rotation(jnp.asarray(h))
    np.testing.assert_allclose(r_ours.numpy(), np.asarray(r_ref), atol=1e-5)
    np.testing.assert_allclose(s_ours.numpy(), np.asarray(s_ref), rtol=1e-5)
    np.testing.assert_allclose(r_ours.numpy() @ r_ours.numpy().T, np.eye(3), atol=1e-5)
