"""The Fast Gauss Transform of the PyTorch port (``tpuslam_torch.ops.fgt``)
and the FGT E-step (``algorithms.cpd.cpd_estep_fgt``) against the JAX
package's ``tpuslam.ops.fgt``, on the same inputs.

Tolerances, with their reasons: the multi-index table and the
coefficients are equal; ``k_center``'s assignments are equal (its
distances are rounded as XLA rounds them) and its centres agree to
float32 sums in another order (1e-6 relative); expansions and
predictions agree to 1e-4 relative (1e-5 absolute): ``exp`` and the
float32 contraction over (K, pd) differ from XLA's in the last bits,
summed over up to 165 terms per centre.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.algorithms.cpd import cpd_estep_fgt as jax_estep_fgt
from tpuslam.algorithms.cpd import sigma_squared_init as jax_sigma2
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam.ops import fgt as jfgt
from tpuslam_torch.algorithms.cpd import cpd_estep_fgt
from tpuslam_torch.ops import fgt

RTOL, ATOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("p", [3, 5, 8, 9])
def test_tables_equal_jax(p):
    np.testing.assert_array_equal(fgt._alpha_table(p), jfgt._alpha_table(p))
    np.testing.assert_array_equal(fgt._c_coefficients(p), jfgt._c_coefficients(p))
    assert fgt.pd_size(p) == jfgt.pd_size(p)


@pytest.mark.parametrize("k,k_rt", [(16, None), (32, None), (32, 20)])
def test_k_center_equals_jax(rng, k, k_rt):
    pts = (rng.random((700, 3)) * 4.0).astype(np.float32)
    cloud = jax_pad_cloud(pts[:650], multiple=128)  # padded rows never picked
    mask = np.asarray(cloud.mask())
    rt_j = None if k_rt is None else jnp.int32(k_rt)
    c_j, i_j = jfgt.k_center(cloud.points, jnp.asarray(mask), k, rt_j)
    rt = None if k_rt is None else torch.tensor(k_rt, dtype=torch.int32)
    c, i = fgt.k_center(_t(cloud.points), _t(mask), k, rt)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), rtol=1e-6, atol=1e-6)
    if k_rt is not None:
        assert int(i.max()) < k_rt


def test_monomials_equal_jax(rng):
    dy = (rng.random((50, 7, 3)) * 2 - 1).astype(np.float32)
    np.testing.assert_array_equal(
        fgt._monomials(_t(dy), 8).numpy(), np.asarray(jfgt._monomials(jnp.asarray(dy), 8)))


def test_model_and_predict_match_jax(rng):
    sources = (rng.random((700, 3)) * 4.0).astype(np.float32)
    targets = (rng.random((500, 3)) * 4.0).astype(np.float32)
    weights = rng.random(700).astype(np.float32)
    sigma = np.float32(2.0)
    m_j = jfgt.compute_fgt_model(jnp.asarray(sources), jnp.asarray(weights),
                                 jnp.float32(sigma), k=32, p=8)
    m = fgt.compute_fgt_model(_t(sources), _t(weights), torch.tensor(sigma), k=32, p=8)
    np.testing.assert_allclose(m.centers.numpy(), np.asarray(m_j.centers), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.ak.numpy(), np.asarray(m_j.ak), rtol=RTOL, atol=ATOL)
    want = np.asarray(jfgt.fgt_predict(jnp.asarray(targets), m_j, jnp.float32(sigma),
                                       e_param=10.0, p=8))
    for chunk in (None, 96, 512):  # chunking changes no value beyond rounding
        got = fgt.fgt_predict(_t(targets), m, torch.tensor(sigma), 10.0, 8, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the exact Gauss transform, as tests/test_fgt.py holds the JAX one
    d2 = ((targets[:, None, :] - sources[None, :, :]) ** 2).sum(-1)
    exact = (np.exp(-d2 / sigma ** 2) * weights[None, :]).sum(1)
    np.testing.assert_allclose(got.numpy(), exact, rtol=2e-3, atol=1e-3)


def test_far_field_cutoff_and_padding(rng):
    a = rng.random((100, 3)).astype(np.float32)
    model = fgt.compute_fgt_model(_t(a), torch.ones(100), torch.tensor(1.0), k=4, p=4)
    far = fgt.fgt_predict(_t(a + 100.0), model, torch.tensor(1.0), 1.0, 4)
    assert torch.all(far == 0.0)
    cloud = jax_pad_cloud(a * 3.0, multiple=512)
    w = np.zeros(512, np.float32)
    w[:100] = 1.0
    padded = fgt.compute_fgt_model(_t(cloud.points), _t(w), torch.tensor(1.5), k=24, p=8)
    tight = fgt.compute_fgt_model(_t(a * 3.0), torch.ones(100), torch.tensor(1.5), k=24, p=8)
    tgt = _t((rng.random((200, 3)) * 3.0).astype(np.float32))
    np.testing.assert_allclose(
        fgt.fgt_predict(tgt, padded, torch.tensor(1.5), 10.0, 8).numpy(),
        fgt.fgt_predict(tgt, tight, torch.tensor(1.5), 10.0, 8).numpy(),
        rtol=1e-5, atol=1e-6)


def test_predict_chunk_by_memory():
    assert fgt.predict_chunk(torch.device("cpu"), 128, 8) == 256
    chunk = fgt.predict_chunk(torch.device("cuda"), 128, 8)
    assert chunk % 256 == 0
    assert chunk * 128 * fgt.pd_size(8) * 4 <= fgt.PREDICT_BYTES_CUDA


@pytest.mark.parametrize("cached", [False, True])
def test_cpd_estep_fgt_matches_jax(rng, cached):
    before = (rng.random((256, 3)) * 4.0).astype(np.float32)
    after = (before + 0.3).astype(np.float32)
    cb, ca = jax_pad_cloud(before), jax_pad_cloud(after)
    mb, ma = cb.mask(), ca.mask()
    s2 = jax_sigma2(cb.points, mb, ca.points, ma)
    m, n, w = jnp.sum(mb), jnp.sum(ma), jnp.float32(0.1)
    kw = {}
    kw_t = {}
    if cached:
        cy, iy = jfgt.k_center(cb.points, mb, 48)
        cx, ix = jfgt.k_center(ca.points, ma, 48)
        kw = dict(sigma2_init=s2 * 2, clusters=(cy, iy, cx, ix))
        kw_t = dict(sigma2_init=_t(s2 * 2), clusters=tuple(_t(x) for x in (cy, iy, cx, ix)))
    else:
        kw = dict(sigma2_init=s2 * 2)
        kw_t = dict(sigma2_init=_t(s2 * 2))
    want = jax_estep_fgt(cb.points, mb, ca.points, ma, s2, w, m, n, 48, 8, 10.0, **kw)
    got = cpd_estep_fgt(_t(cb.points), _t(mb), _t(ca.points), _t(ma), _t(s2),
                        _t(w), _t(m), _t(n), 48, 8, 10.0, **kw_t)
    for f in ("p1", "pt1", "px"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-5)


def test_segment_sum_against_float64_index_add(rng):
    """The fixed-order segment sum against a float64 ``index_add_``: float32
    sums of about 300 terms each, within 1e-5 of the largest |sum|; an
    empty cluster gives exactly 0; each cluster's rows are added one
    after the other in their original order, bit for bit."""
    k = 20
    indx = rng.integers(0, 16, size=5000).astype(np.int32)  # clusters 16..19 empty
    vals = rng.standard_normal((5000, 7, 2)).astype(np.float32)
    seg = fgt.segment_order(_t(indx), k)
    got = fgt.segment_sum(_t(vals)[seg.order], seg.lengths)
    want = torch.zeros((k, 7, 2), dtype=torch.float64).index_add_(
        0, _t(indx).long(), _t(vals).double())
    assert got.shape == (k, 7, 2) and got.dtype == torch.float32
    assert bool((got[16:] == 0).all())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    acc = torch.zeros((7, 2))
    for row in np.flatnonzero(indx == 3):
        acc = acc + _t(vals[row])
    assert torch.equal(got[3], acc)


def test_segment_order_is_stable(rng):
    indx = rng.integers(0, 9, size=777).astype(np.int32)
    seg = fgt.segment_order(_t(indx), 12)
    order = seg.order.numpy()
    np.testing.assert_array_equal(order, np.argsort(indx, kind="stable"))
    np.testing.assert_array_equal(seg.lengths.numpy(), np.bincount(indx, minlength=12))


def test_clustering_cache_carries_the_order(rng, monkeypatch):
    """``k_center_ordered`` hands back the order its centres were summed
    in; a model built from the cached clustering and order equals one
    built from scratch, bit for bit; the CPD loop sorts once per
    clustering, never per E-step."""
    pts = _t((rng.random((900, 3)) * 4.0).astype(np.float32))
    mask = torch.ones(900)
    mask[-50:] = 0.0
    centers, indx, seg = fgt.k_center_ordered(pts, mask, 24)
    c0, i0 = fgt.k_center(pts, mask, 24)
    assert torch.equal(centers, c0) and torch.equal(indx, i0)
    want = fgt.segment_order(indx, 24)
    assert torch.equal(seg.order, want.order) and torch.equal(seg.lengths, want.lengths)
    w = _t(rng.random((900, 4)).astype(np.float32)) * mask[:, None]
    sigma = torch.tensor(1.5)
    cached = fgt.compute_fgt_model_multi(pts, w, mask, sigma, 24, 8,
                                         clustering=(centers, indx), order=seg)
    fresh = fgt.compute_fgt_model_multi(pts, w, mask, sigma, 24, 8)
    assert torch.equal(cached.ak, fresh.ak) and torch.equal(cached.centers, fresh.centers)

    from tpuslam_torch.algorithms.cpd import cpd_register
    from tpuslam_torch.config.configuration import ApproximationType
    from tpuslam_torch.core.types import pad_cloud

    sorts = []
    real = fgt.segment_order
    monkeypatch.setattr(fgt, "segment_order", lambda *a: sorts.append(1) or real(*a))
    b = (rng.random((600, 3)) * 4.0).astype(np.float32)
    out = cpd_register(pad_cloud(b), pad_cloud(b + 0.05), weight=0.1, max_iterations=4,
                       tolerance=0.0, approximation_type=ApproximationType.Full,
                       use_fgt=True, fgt_k=16)
    assert out.iterations == 4 and len(sorts) == 2  # one per cloud's clustering
