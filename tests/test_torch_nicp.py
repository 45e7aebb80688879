"""NICP of the PyTorch port (``tpuslam_torch.algorithms.nicp``) against the
JAX package's (``tpuslam.algorithms.nicp``) on the same inputs.

Tolerances, with their reasons:

* the subcloud scores and the subcloud's indices: bit for bit, the port
  draws JAX's threefry bits itself (``algorithms/prng.py``);
* ``spectrum_gaps`` and ``degenerate_axes_for``: bit for bit (numpy, a
  copy);
* ``principal_axes``: eigenvalues within 1e-5 relative and axes within
  1e-4 up to sign (LAPACK's ``syevd`` behind both, summed scatters in
  another order);
* candidates: the same set up to order, within 1e-5 (eigenvector signs
  may differ, which reorders the sign enumeration);
* ``nicp_register``: R within 1e-4, t within 1e-4 times the cloud's
  spread, the error within 1e-4 relative, equal ``iterations`` (the
  transformed subcloud and the 3x3 products round differently);
* widened runs (a degenerate spectrum, where the basis inside the tied
  subspace is arbitrary): held to the truth at ``tests/test_nicp.py``'s
  thresholds, not to the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam
import tpuslam_torch
from tests.conftest import random_rigid
from tests.test_nicp import anisotropic_cloud, degenerate_cylinder, degenerate_pair, gt_mse_of
from tpuslam.algorithms import nicp as jnicp
from tpuslam.config.configuration import ApproximationType as JaxApprox
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam_torch.algorithms import nicp, prng
from tpuslam_torch.config.configuration import ApproximationType, ComputationMethod
from tpuslam_torch.core.types import pad_cloud

SPREAD = 10.0  # the anisotropic cloud's largest extent


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes, and torch's default of a thread per core in each of them
    oversubscribes the cores (the plain K1 here ran ~25x slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [128, 1000, 2**20])
@pytest.mark.parametrize("seed", [0, 1, 3, 12345, 2**32 + 7])
def test_uniform_equals_jax_bit_for_bit(seed, n):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))
    got = prng.uniform(seed, n).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_depends_on_the_row_alone():
    """A row's score is the same at every padded size."""
    long = prng.uniform(5, 4096)
    assert torch.equal(prng.uniform(5, 640), long[:640])


@pytest.mark.parametrize("case", ["draw", "planted ties", "masked rows"])
def test_top_k_order_equals_lax_top_k(case):
    n, k = 2**20, 1024
    scores = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (n,)))
    if case == "planted ties":
        # the 1,024th and 1,025th scores and a run of 40 inside the top k
        # made equal, and 100 copies of the maximum
        order = np.argsort(-scores, kind="stable")
        scores = scores.copy()
        scores[order[1024]] = scores[order[1023]]
        scores[order[500:540]] = scores[order[500]]
        scores[np.random.Generator(np.random.PCG64(3)).choice(n, 100, replace=False)] = scores.max()
    if case == "masked rows":
        # NICP's draw: rows past the count score -1 (all tied), and the
        # whole cloud fits in k
        scores = np.where(np.arange(n) < 700, scores, -1.0).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(scores), k)
    got = prng.top_k_order(torch.from_numpy(np.array(scores)), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [1, 7])
def test_subcloud_indices_equal_jax(rng, seed):
    """The rows NICP scores: JAX's draw, masked, then ``lax.top_k``."""
    cloud = pad_cloud(anisotropic_cloud(rng, 3000))
    k = 1024
    mask = cloud.mask()
    scores = torch.where(mask > 0, prng.uniform(seed, cloud.padded_size), -1.0)
    j_scores = jnp.where(jnp.asarray(mask.numpy()) > 0,
                         jax.random.uniform(jax.random.PRNGKey(seed), (cloud.padded_size,)), -1.0)
    np.testing.assert_array_equal(prng.top_k_order(scores, k).numpy(),
                                  np.asarray(jax.lax.top_k(j_scores, k)[1]))


def _shapes(rng):
    cyl = degenerate_cylinder(rng)
    v = rng.standard_normal((4000, 3)).astype(np.float32)
    sphere = v / np.linalg.norm(v, axis=1, keepdims=True)
    return {"cylinder": cyl, "sphere": sphere, "anisotropic": anisotropic_cloud(rng, 2000),
            "tiny": anisotropic_cloud(rng, 3), "large": anisotropic_cloud(rng, 40_000)}


def test_spectrum_gaps_and_degenerate_axes_bit_equal(rng):
    shapes = _shapes(rng)
    for name, pts in shapes.items():
        assert nicp.spectrum_gaps(pts) == jnicp.spectrum_gaps(pts), name
        for other in shapes.values():
            assert nicp.degenerate_axes_for(pts, other) == jnicp.degenerate_axes_for(pts, other)
    assert nicp.degenerate_axes_for(shapes["cylinder"], shapes["cylinder"]) == (0,)
    assert nicp.degenerate_axes_for(shapes["sphere"], shapes["sphere"]) == (0, 2)


@pytest.mark.parametrize("n", [500, 3000])
def test_principal_axes(rng, n):
    cloud_np = anisotropic_cloud(rng, n) + np.float32(3.0)
    cloud, jcloud = pad_cloud(cloud_np, multiple=512), jax_pad_cloud(cloud_np, multiple=512)
    u, ev = nicp.principal_axes(cloud.points, cloud.mask())
    ju, jev = jnicp.principal_axes(jcloud.points, jcloud.mask())
    np.testing.assert_allclose(ev.numpy(), np.asarray(jev), rtol=1e-5)
    # each axis up to its sign
    ju = np.asarray(ju)
    signs = np.sign(np.sum(u.numpy() * ju, axis=0))
    np.testing.assert_allclose(u.numpy() * signs, ju, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        nicp.masked_centroid(cloud.points, cloud.mask()).numpy(),
        np.asarray(jnicp.masked_centroid(jcloud.points, jcloud.mask())), rtol=0, atol=1e-5)


def _sorted_rows(rots, trs):
    flat = np.concatenate([rots.reshape(len(rots), 9), trs], axis=1)
    return flat[np.lexsort(np.round(flat, 3).T[::-1])]


@pytest.mark.parametrize("angles,axes", [(0, ()), (16, (0,)), (5, (0, 2))])
def test_candidate_set_equal_up_to_order(rng, angles, axes):
    b = anisotropic_cloud(rng, 800)
    r, t = random_rigid(rng, 0.5, 3.0)
    a = (b @ r.T + t).astype(np.float32)
    port, jax_ = [], []
    for mod, pad, out in ((nicp, pad_cloud, port), (jnicp, jax_pad_cloud, jax_)):
        cb, ca = pad(b), pad(a)
        ub, _ = mod.principal_axes(cb.points, cb.mask())
        ua, _ = mod.principal_axes(ca.points, ca.mask())
        mb = mod.masked_centroid(cb.points, cb.mask())
        ma = mod.masked_centroid(ca.points, ca.mask())
        c = mod._enumerate_candidates(ub, ua, mb, ma, degenerate_angles=angles,
                                      degenerate_axes=axes)
        proper = np.asarray(c.proper)
        out.append((np.asarray(c.rotations)[proper], np.asarray(c.translations)[proper]))
    (pr, pt), (jr, jt) = port[0], jax_[0]
    assert len(pr) == len(jr) == 4 * (1 + (angles - 1) * len(axes) if angles else 1)
    np.testing.assert_allclose(_sorted_rows(pr, pt / SPREAD), _sorted_rows(jr, jt / SPREAD),
                               rtol=0, atol=1e-5)


def _noisy_pair(rng, n, angle, trans, shuffle=True):
    before = anisotropic_cloud(rng, n)
    r, t = random_rigid(rng, angle, trans)
    after = (before @ r.T + t).astype(np.float32)
    after = after + rng.normal(0, 0.01, after.shape).astype(np.float32)
    if shuffle:
        after = after[rng.permutation(n)]
    return before, after.astype(np.float32), r, t


@pytest.mark.parametrize("mode,n,shuffle", [
    ("NONE", 700, True), ("Hybrid", 700, True), ("Full", 500, False),
    ("NONE", 2500, True),  # the subcloud is a strict subset of the cloud
])
def test_nicp_register_matches_jax(rng, mode, n, shuffle):
    before, after, r, t = _noisy_pair(rng, n, 0.4, 5.0, shuffle)
    kw = dict(seed=3, subcloud_size=1000)
    want = jnicp.nicp_register(jax_pad_cloud(before), jax_pad_cloud(after),
                               approximation_type=JaxApprox[mode], **kw)
    got = nicp.nicp_register(pad_cloud(before), pad_cloud(after),
                             approximation_type=ApproximationType[mode], **kw)
    assert got.iterations == int(want.iterations) == 4
    np.testing.assert_allclose(got.transform.rotation.numpy(),
                               np.asarray(want.transform.rotation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.transform.translation.numpy(),
                               np.asarray(want.transform.translation), rtol=0, atol=1e-4 * SPREAD)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-4)
    np.testing.assert_allclose(got.transform.rotation.numpy(), r, atol=2e-2)


def test_nicp_small_cloud_and_padding(rng):
    """A cloud smaller than the subcloud is used whole, and the padded
    size does not change the result (the draw depends on the row alone)."""
    before, after, r, t = _noisy_pair(rng, 300, 0.3, 2.0)
    a = nicp.nicp_register(pad_cloud(before, multiple=128), pad_cloud(after, multiple=128))
    b = nicp.nicp_register(pad_cloud(before, multiple=512), pad_cloud(after, multiple=512))
    np.testing.assert_allclose(a.transform.rotation.numpy(), b.transform.rotation.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.transform.translation.numpy(),
                               b.transform.translation.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.transform.rotation.numpy(), r, atol=2e-2)


def test_nicp_cylinder_widened_recovers_the_truth(rng):
    """``tests/test_nicp.py::test_nicp_cylinder_degenerate_recovery`` on
    the port: 70 degrees about the cylinder's axis, off the 22.5-degree
    grid.  Subcloud 1000 instead of 2000 (half the plain version's rows on
    the CPU); the determinism check is the sphere's below."""
    before, after, r, t = degenerate_pair(rng)
    cb, ca = pad_cloud(before), pad_cloud(after)
    kw = dict(degenerate_angles=16, degenerate_axes=(0,), seed=1, subcloud_size=1000)
    widened = nicp.nicp_register(cb, ca, **kw)
    rot = widened.transform.rotation.numpy()
    assert np.linalg.det(rot) == pytest.approx(1.0, abs=1e-3)
    assert widened.iterations == 4 * 16
    mse_w = gt_mse_of(before, r, t, rot, widened.transform.translation.numpy())
    assert mse_w < 2e-3
    base = nicp.nicp_register(cb, ca, seed=1, subcloud_size=1000)
    mse_b = gt_mse_of(before, r, t, base.transform.rotation.numpy(),
                      base.transform.translation.numpy())
    assert mse_w < mse_b / 10


def test_nicp_sphere_widened_deterministic_and_on_the_shell(rng):
    """``tests/test_nicp.py::test_nicp_sphere_never_worse_and_deterministic``
    on the port: both axes widened (248 candidates), at 2,000 points and a
    256-row subcloud instead of 4,000 and 1,024 (the plain version's cost
    on the CPU)."""
    v = rng.standard_normal((2000, 3)).astype(np.float32)
    before = v / np.linalg.norm(v, axis=1, keepdims=True)
    r, t = random_rigid(rng, angle=1.0, trans=2.0)
    after = (before @ r.T + t)[rng.permutation(len(before))].astype(np.float32)
    cb, ca = pad_cloud(before), pad_cloud(after)
    kw = dict(degenerate_angles=16, degenerate_axes=(0, 2), seed=1, subcloud_size=256)
    res1 = nicp.nicp_register(cb, ca, **kw)
    res2 = nicp.nicp_register(cb, ca, **kw)
    assert res1.iterations == 4 * 31
    assert torch.equal(res1.transform.rotation, res2.transform.rotation)
    rot = res1.transform.rotation.numpy()
    assert np.linalg.det(rot) == pytest.approx(1.0, abs=1e-3)
    moved = before @ rot.T + res1.transform.translation.numpy()
    np.testing.assert_allclose(np.linalg.norm(moved - t, axis=1), 1.0, atol=0.05)


@pytest.mark.parametrize("mode", ["NONE", "Full"])
def test_register_nicp_matches_jax_register(rng, mode):
    before, after, _, _ = _noisy_pair(rng, 900, 0.3, 4.0, shuffle=(mode != "Full"))
    kw = dict(computation_method=ComputationMethod.NoniterativeIcp, random_seed=7,
              approximation_type=ApproximationType[mode])
    got = tpuslam_torch.register(before, after, device="cpu", **kw)
    want = tpuslam.register(before, after,
                            computation_method=tpuslam.ComputationMethod.NoniterativeIcp,
                            random_seed=7, approximation_type=JaxApprox[mode])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4 * SPREAD)
    assert got[2] == want[2] == 4
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4)


def test_register_nicp_auto_widening_and_opt_out(rng):
    """``tests/test_nicp.py::test_nicp_degenerate_auto_via_registry`` on
    the port: the eigengap pre-pass widens the cylinder with no knob set,
    and ``nicp_degenerate_widening=0`` turns it off (subcloud 1000, as
    above)."""
    before, after, r, t = degenerate_pair(rng)
    kw = dict(computation_method=ComputationMethod.NoniterativeIcp, random_seed=1,
              nicp_subcloud_size=1000)
    rot, tr, iters, _ = tpuslam_torch.register(before, after, device="cpu", **kw)
    assert iters == 4 * 16
    assert gt_mse_of(before, r, t, rot, tr) < 2e-3
    rot0, tr0, iters0, _ = tpuslam_torch.register(before, after, device="cpu",
                                                  nicp_degenerate_widening=0, **kw)
    assert iters0 == 4
    assert gt_mse_of(before, r, t, rot0, tr0) > 2e-3


@pytest.mark.parametrize("widen,expected", [(None, (16, (0,))), (0, (0, ())), (1, (0, ())),
                                            (8, (8, (0,)))])
def test_widening_knob(rng, widen, expected):
    from tpuslam_torch.algorithms.registry import nicp_widening

    cyl = degenerate_cylinder(rng)
    assert nicp_widening(cyl, cyl, widen) == expected
    aniso = anisotropic_cloud(rng, 2000)
    # forced widening of a non-degenerate cloud widens axis 0
    assert nicp_widening(aniso, aniso, widen) == ((0, ()) if widen in (None, 0, 1)
                                                  else (widen, (0,)))
