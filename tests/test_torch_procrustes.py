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


def test_batched_procrustes_equals_solo_calls_on_the_cpu(rng):
    """P's wrappers on the CPU run the plain version pair by pair: each pair
    of a batch gets its solo call's bits (R, t, the SVD entry, the error)."""
    from tpuslam_torch.kernels import procrustes as kp

    b, n = 4, 300
    before = _t(np.stack([make_cloud(rng, n) for _ in range(b)]))
    after = _t(np.stack([make_cloud(rng, n) for _ in range(b)]))
    w = _t((rng.random((b, n)) > 0.3).astype(np.float32))
    r, t = procrustes.weighted_procrustes(before, after, w)
    h = _t(rng.normal(size=(b, 3, 3)))
    sr, ss, sd = procrustes.svd_rotation_det(h)
    diff = after - before
    err = procrustes.mean_sq_error(diff, w, w.sum(1))
    for p in range(b):
        r1, t1 = procrustes.weighted_procrustes(before[p], after[p], w[p])
        assert torch.equal(r1, r[p]) and torch.equal(t1, t[p])
        assert torch.equal(kp.weighted_procrustes_ref(before[p], after[p], w[p])[0], r[p])
        for x, y in zip(procrustes.svd_rotation_det(h[p]), (sr[p], ss[p], sd[p])):
            assert torch.equal(x, y)
        assert torch.equal(procrustes.mean_sq_error(diff[p], w[p], w[p].sum()), err[p])
    assert kp.LAUNCHES == 0  # the CPU launches nothing


def test_svd_rotation_det_matches_jax_with_sorted_values(rng):
    """The SVD entry against the JAX package's ``svd_rotation`` on a batch,
    with a reflection among them: R within 1e-5, singular values
    non-negative and descending (LAPACK's order, which the CPD scale's
    ``s0 + s1 + det s2`` needs), det(U V^T) = sign(det H)."""
    hs = rng.normal(size=(5, 3, 3)).astype(np.float32)
    hs[2, :, 0] *= -1 if np.linalg.det(hs[2]) > 0 else 1
    r, s, det = procrustes.svd_rotation_det(_t(hs))
    for p in range(5):
        r_ref, s_ref = jax_procrustes.svd_rotation(jnp.asarray(hs[p]))
        np.testing.assert_allclose(r[p].numpy(), np.asarray(r_ref), atol=1e-5)
        np.testing.assert_allclose(s[p].numpy(), np.asarray(s_ref), rtol=1e-5)
        assert (s[p] >= 0).all() and s[p][0] >= s[p][1] >= s[p][2]
        assert float(det[p]) == pytest.approx(np.sign(np.linalg.det(hs[p])), abs=1e-5)


@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_non_finite_cross_covariance_gives_nan(value):
    h = np.eye(3, dtype=np.float32)
    h[0, 2] = value
    r, s, det = procrustes.svd_rotation_det(_t(h))
    assert torch.isnan(r).all() and torch.isnan(s).all() and torch.isnan(det)


def test_procrustes_wrappers_refuse_bad_operands(rng):
    from tpuslam_torch.kernels import procrustes as kp

    pts = _t(make_cloud(rng, 16))[None]
    with pytest.raises(ValueError, match="weights"):
        kp.weighted_procrustes_batch(pts, pts, torch.ones(1, 15))
    with pytest.raises(TypeError, match="float32"):
        kp.weighted_procrustes_batch(pts.double(), pts.double(), torch.ones(1, 16).double())
    with pytest.raises(ValueError, match=r"\[B, 3, 3\]"):
        kp.svd_rotation_det_batch(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="n_corr"):
        kp.mean_sq_error_batch(pts, torch.ones(1, 16), torch.ones(2))
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        kp.weighted_procrustes_batch(pts.to("meta"), pts.to("meta"), torch.ones(1, 16,
                                                                                 device="meta"))


def _moments_operands(rng, b, m, n):
    p1 = _t(rng.random((b, m)))
    moving = _t(rng.random((b, m, 3)) * 10 - 5)
    px = _t(rng.random((b, m, 3)) * 2 - 1)
    pt1 = _t(rng.random((b, n)))
    target = _t(rng.random((b, n, 3)) * 10 - 5)
    return p1, moving, px, pt1, target


@pytest.mark.parametrize("m,n", [(300, 250), (1500, 700), (1, 0)])
def test_mstep_moments_plain_version_matches_float64(rng, m, n):
    """P's moments entry (the CPD M-step's sums) on the CPU: each pair's 18
    sums in float64 over chunks of ``CHUNK_ROWS`` rows against a float64
    torch reference summed in one go, within 1e-12 relative to the sum of
    the terms' magnitudes; a pair's bits are the same at B = 1 and B = 3."""
    from tpuslam_torch.kernels import procrustes as kp

    ops = _moments_operands(rng, 3, m, n)
    sums = kp.mstep_moments_batch(*ops)
    assert sums.shape == (3, kp.MSTEP_WIDTH) and sums.dtype == torch.float64
    for b in range(3):
        p, y, x, q, t = (o[b].double() for o in ops)
        terms = [p[:, None], p[:, None] * y, q[:, None] * t,
                 (x[:, :, None] * y[:, None, :]).reshape(-1, 9),
                 (q * (t * t).sum(1))[:, None], (p * (y * y).sum(1))[:, None]]
        ref = torch.cat([z.sum(0) for z in terms])
        scale = torch.cat([z.abs().sum(0) for z in terms])
        assert bool(((sums[b] - ref).abs() <= 1e-12 * scale + 1e-300).all())
        solo = kp.mstep_moments_batch(*(o[b:b + 1] for o in ops))
        assert torch.equal(solo[0], sums[b])


def test_mstep_from_moments_matches_the_float32_mstep(rng):
    """The M-step from P's float64 sums against the float32 products it
    replaced (A = px^T B - Np mu_a mu_b^T in float32 ``matmul``s), in both
    scale branches: R, t, scale and sigma^2 within 1e-5 relative."""
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.core.types import Sufficient

    p1, mv, px, pt1, tg = (o[0] for o in _moments_operands(rng, 1, 400, 300))
    stats = Sufficient(p1=p1, pt1=pt1, px=px, error=None)
    for const_scale in (False, True):
        got = cpd.cpd_mstep(mv, tg, stats, const_scale, torch.tensor(0.9))
        np_ = p1.sum()
        mu_b, mu_a = p1 @ mv / np_, pt1 @ tg / np_
        a_mat = px.T @ mv - np_ * torch.outer(mu_a, mu_b)
        want = cpd.mstep_from_moments(
            np_, mu_b, mu_a, a_mat, (pt1 * (tg * tg).sum(1)).sum() - np_ * mu_a @ mu_a,
            (p1 * (mv * mv).sum(1)).sum() - np_ * mu_b @ mu_b, const_scale, torch.tensor(0.9))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
