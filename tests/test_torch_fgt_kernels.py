"""The wrappers of K6 and K7 (``tpuslam_torch/kernels/fgt.py``) on the CPU:
CPU tensors take the plain versions, which give the torch composition's
bits as ``ops/fgt.py`` computed them before the kernels came; operands
the kernels do not take raise before any launch.  The kernels themselves
run only on a card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from tpuslam_torch import kernels
from tpuslam_torch.kernels import fgt as kfgt
from tpuslam_torch.ops import fgt


@pytest.fixture
def rng():
    return np.random.Generator(np.random.PCG64(2106))


def _composition_predict(targets, centers, ak, sigma, e_param, p, chunk):
    """``ops/fgt.py::fgt_predict_multi``'s body as it stood before K6."""
    m = targets.shape[0]
    k, pd, w = ak.shape
    flat = ak.reshape(k * pd, w)
    out = torch.empty((m, w), dtype=torch.float32)
    for lo in range(0, m, chunk):
        tgt = targets[lo:lo + chunk]
        dy = (tgt[:, None, :] - centers[None, :, :]) / sigma
        s = torch.sum(dy * dy, dim=-1)
        g = torch.where(s > e_param, torch.zeros_like(s), torch.exp(-s))
        prods = fgt._monomials(dy, p)
        out[lo:lo + chunk] = torch.matmul((g[:, :, None] * prods).reshape(tgt.shape[0], k * pd),
                                          flat)
    return out


def _composition_expand(points, weights, mask, sigma, centers, indx, order, p):
    """``ops/fgt.py::compute_fgt_model_multi``'s expansion as it stood
    before K7."""
    rows = order.order
    dy = (points.index_select(0, rows)
          - centers.index_select(0, indx.index_select(0, rows))) / sigma
    g = torch.exp(-torch.sum(dy * dy, dim=-1)) * mask.index_select(0, rows)
    contrib = fgt._monomials(dy, p)[:, :, None] * (g[:, None, None]
                                                   * weights.index_select(0, rows)[:, None, :])
    return fgt.segment_sum(contrib, order.lengths) * fgt.fgt_tables(p, "cpu").coeff[None, :, None]


def _operands(rng, n=700, k=12, w=4):
    pts = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32))
    mask = torch.ones(n)
    mask[-20:] = 0.0
    pts[-20:] = 0.0
    weights = torch.from_numpy(rng.random((n, w)).astype(np.float32)) * mask[:, None]
    centers, indx, order = fgt.k_center_ordered(pts, mask, k)
    return pts, weights.contiguous(), mask, centers, indx, order


@pytest.mark.parametrize("p", [8, 5])
@pytest.mark.parametrize("w", [1, 4])
def test_cpu_takes_the_plain_version_bit_equal_to_the_composition(rng, w, p):
    pts, weights, mask, centers, indx, order = _operands(rng, w=w)
    sigma = torch.tensor(1.7)
    targets = torch.from_numpy((rng.random((333, 3)) * 10).astype(np.float32))
    launches, plain = kernels.launch_counts(), kfgt.PLAIN_CALLS["cpu"]
    model = fgt.compute_fgt_model_multi(pts, weights, mask, sigma, 12, p,
                                        clustering=(centers, indx), order=order)
    want_ak = _composition_expand(pts, weights, mask, sigma, centers, indx, order, p)
    assert torch.equal(model.ak, want_ak)
    for chunk in (None, 100):
        got = fgt.fgt_predict_multi(targets, model, sigma, 10.0, p, chunk)
        want = _composition_predict(targets, centers, want_ak, sigma, 10.0, p,
                                    chunk or fgt.PREDICT_CHUNK_CPU)
        assert torch.equal(got, want)
    assert kfgt.PLAIN_CALLS["cpu"] == plain + 3
    delta = kernels.launch_delta(launches)
    assert delta["K6"] == delta["K7"] == 0


def _bad_predict(rng, case):
    pts, weights, mask, centers, indx, order = _operands(rng)
    ak = kfgt.expand(pts, weights, mask, 1.5, centers, indx, order, 8)
    tg = pts[:50].clone()
    args = dict(targets=tg, centers=centers, ak=ak, sigma=1.5, e_param=10.0, p=8)
    args.update({
        "targets float64": dict(targets=tg.double()),
        "targets [M, 2]": dict(targets=tg[:, :2].contiguous()),
        "targets strided": dict(targets=pts[:100:2]),
        "ak of another order": dict(p=6),
        "ak of other centres": dict(centers=centers[:5].contiguous()),
        "order 0": dict(p=0),
    }[case])
    return lambda: kfgt.predict(**args)


def _bad_expand(rng, case):
    pts, weights, mask, centers, indx, order = _operands(rng)
    args = dict(points=pts, weights=weights, mask=mask, sigma=1.5, centers=centers, indx=indx,
                order=order, p=8)
    args.update({
        "points strided": dict(points=torch.cat([pts, pts], 1)[:, ::2]),
        "weights of other rows": dict(weights=weights[:-1]),
        "mask float64": dict(mask=mask.double()),
        "order int32": dict(order=fgt.SegmentOrder(order.order.int(), order.lengths)),
        "lengths of other clusters": dict(order=fgt.SegmentOrder(order.order,
                                                                 order.lengths[:-1])),
        "order not an int": dict(p=8.0),
    }[case])
    return lambda: kfgt.expand(**args)


@pytest.mark.parametrize("case", ["targets float64", "targets [M, 2]", "targets strided",
                                  "ak of another order", "ak of other centres", "order 0"])
def test_predict_refuses_bad_operands_before_any_launch(rng, case):
    call = _bad_predict(rng, case)
    plain = kfgt.PLAIN_CALLS["cpu"]
    with pytest.raises((TypeError, ValueError)):
        call()
    assert kfgt.PLAIN_CALLS["cpu"] == plain


@pytest.mark.parametrize("case", ["points strided", "weights of other rows", "mask float64",
                                  "order int32", "lengths of other clusters",
                                  "order not an int"])
def test_expand_refuses_bad_operands_before_any_launch(rng, case):
    call = _bad_expand(rng, case)
    plain = kfgt.PLAIN_CALLS["cpu"]
    with pytest.raises((TypeError, ValueError)):
        call()
    assert kfgt.PLAIN_CALLS["cpu"] == plain


@pytest.mark.parametrize("p,w", [(1, 1), (6, 4), (8, 1), (8, 4), (40, 4), (1024, 4)])
def test_expand_geometry_fits_the_kernel(p, w):
    """K7's staged rows and shared memory: at least one row and at most
    a block's 512, the rows' powers and weights and the groups' sums in
    the 48 KB a block may use without opting in."""
    rows, smem = kfgt.expand_geometry(p, w)
    assert 1 <= rows <= kfgt.EXPAND_THREADS
    assert rows * (3 * p + w) * 4 <= kfgt.EXPAND_STAGE_BYTES
    assert smem == 4 * max(rows * (3 * p + w), kfgt.EXPAND_THREADS * w) <= 48 * 1024


def test_k6_and_k7_are_counted_kernels():
    """Both count on the device and in the launch readings, under the
    names K6 and K7, and a reset clears them."""
    assert list(kernels.TALLIED)[-2:] == ["K6", "K7"]
    assert kernels.TALLIED["K6"] == ("fgt", "PREDICT_LAUNCHES")
    assert kernels.TALLIED["K7"] == ("fgt", "EXPAND_LAUNCHES")
    kfgt.PREDICT_LAUNCHES, kfgt.EXPAND_LAUNCHES = 3, 5
    counts = kernels.launch_counts()
    assert (counts["K6"], counts["K7"]) == (3, 5)
    kernels.reset_launch_counts()
    assert (kfgt.PREDICT_LAUNCHES, kfgt.EXPAND_LAUNCHES) == (0, 0)
