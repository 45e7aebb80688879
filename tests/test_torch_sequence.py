"""Sequence odometry of the PyTorch port (``tpuslam_torch.algorithms.sequence``,
``tpuslam_torch.register_sequence``, ``tpuslam_torch.sequence_stream``):
every case of ``tests/test_sequence.py`` on the port, each lowering and
the stream against their JAX twins on the same numpy scans, and the
presorted hierarchical target against the JAX package's.

Tolerances, with their reasons:

* against the JAX twin: equal iterations per pair, R and t within 1e-4
  (the whole registrations' tolerance of ``tests/test_torch_icp.py``:
  cuSOLVER or LAPACK against XLA's SVD, and XLA's fused transforms);
* ``prepare_hier_target(presorted=True)`` against JAX's: bit for bit;
* the port's scan pair 0 against ``icp_register`` with patience 8 and the
  guard off, the per-pair pair 0 against the cold call: bit for bit (the
  same loop on the same rows); the stream against the scan lowering of
  the same scans: bit for bit (the same staging and the same loop);
* poses against the truth: the JAX tests' bounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuslam_torch
from tests.test_sequence import _make_trajectory, _pose_error
from tpuslam.algorithms import sequence as jseq
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam.ops import nn_hier as jax_hier
from tpuslam.ops.spatial import host_morton_order as jax_host_morton_order
from tpuslam_torch.algorithms.icp import icp_register
from tpuslam_torch.algorithms.sequence import SEED_PATIENCE, SequenceStream
from tpuslam_torch.core.types import Cloud, pad_cloud
from tpuslam_torch.ops import nn_hier
from tpuslam_torch.ops.spatial import host_morton_order

KW = dict(max_iterations=60, max_distance_squared=1e6)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes (see ``tests/test_torch_batch.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def register_sequence(scans, **kw):
    return tpuslam_torch.register_sequence(scans, device="cpu", **kw)


def _assert_near_jax(port, jax_res, atol=1e-4):
    np.testing.assert_array_equal(port.iterations, np.asarray(jax_res.iterations))
    for p, j in zip(port.relative, jax_res.relative):
        np.testing.assert_allclose(p.rotation, np.asarray(j.rotation), rtol=0, atol=atol)
        np.testing.assert_allclose(p.translation, np.asarray(j.translation), rtol=0, atol=atol)
    for p, j in zip(port.absolute, jax_res.absolute):
        np.testing.assert_allclose(p.rotation, np.asarray(j.rotation), rtol=0, atol=atol)


# every case of tests/test_sequence.py -------------------------------------------


@pytest.mark.parametrize("batch", [False, True])
def test_register_sequence_recovers_trajectory(rng, batch):
    scans, poses = _make_trajectory(rng)
    out = register_sequence(scans, batch=batch, **KW)
    assert len(out.relative) == len(scans) - 1
    assert len(out.absolute) == len(scans)
    for k, (true_r, true_t) in enumerate(poses):
        dev, terr = _pose_error(out.absolute[k].rotation, out.absolute[k].translation,
                                true_r, true_t)
        assert dev < 1.0 and terr < 0.15, (k, dev, terr, batch)


def test_register_sequence_seed_reduces_iterations(rng):
    scans, _ = _make_trajectory(rng, n_scans=5)
    seeded = register_sequence(scans, **KW)
    cold = register_sequence(scans, seed_with_previous=False, **KW)
    assert seeded.iterations[1:].sum() <= cold.iterations[1:].sum()
    for k in range(len(scans) - 1):
        assert seeded.errors[k] < 5e-3


def test_register_sequence_mixed_sizes(rng):
    scans, poses = _make_trajectory(rng, n_scans=3, n_pts=1100)
    scans[1] = scans[1][:700]
    out = register_sequence(scans, **KW)
    dev, terr = _pose_error(out.absolute[-1].rotation, out.absolute[-1].translation,
                            poses[-1][0], poses[-1][1])
    assert dev < 1.5 and terr < 0.2
    _assert_near_jax(out, jseq.register_sequence(scans, **KW))


def test_register_sequence_needs_two(rng):
    with pytest.raises(ValueError):
        register_sequence([np.zeros((10, 3), np.float32)])


def test_seeded_accuracy_matches_unseeded(rng):
    scans, poses = _make_trajectory(rng, n_scans=6)
    seeded = register_sequence(scans, **KW)
    cold = register_sequence(scans, seed_with_previous=False, **KW)
    for k, (true_r, true_t) in enumerate(poses):
        dev_s, terr_s = _pose_error(seeded.absolute[k].rotation,
                                    seeded.absolute[k].translation, true_r, true_t)
        dev_c, terr_c = _pose_error(cold.absolute[k].rotation, cold.absolute[k].translation,
                                    true_r, true_t)
        assert dev_s <= max(2.0 * dev_c, 0.5), (k, dev_s, dev_c)
        assert terr_s <= max(2.0 * terr_c, 0.05), (k, terr_s, terr_c)


def test_scan_lowering_matches_per_pair(rng):
    scans, poses = _make_trajectory(rng)
    scanned = register_sequence(scans, **KW)
    perpair = register_sequence(scans, scan=False, **KW)
    for k, (true_r, true_t) in enumerate(poses):
        for out in (scanned, perpair):
            dev, terr = _pose_error(out.absolute[k].rotation, out.absolute[k].translation,
                                    true_r, true_t)
            assert dev < 1.0 and terr < 0.15, (k, dev, terr)


def test_scan_lowering_chunked_dispatch_identical(rng):
    scans, _ = _make_trajectory(rng, n_scans=6)
    whole = register_sequence(scans, **KW)
    parts = register_sequence(scans, pairs_per_dispatch=2, **KW)
    for k in range(len(scans) - 1):
        np.testing.assert_array_equal(whole.relative[k].rotation, parts.relative[k].rotation)
        np.testing.assert_array_equal(whole.relative[k].translation,
                                      parts.relative[k].translation)
    np.testing.assert_array_equal(whole.iterations, parts.iterations)


def test_scan_lowering_spatial_arm(rng):
    scans, poses = _make_trajectory(rng, n_scans=3, n_pts=700, step_angle=0.05,
                                    step_trans=0.3)
    kw = dict(max_iterations=40, max_distance_squared=1e6, use_spatial=True)
    out = register_sequence(scans, **kw)
    for k, (true_r, true_t) in enumerate(poses):
        dev, terr = _pose_error(out.absolute[k].rotation, out.absolute[k].translation,
                                true_r, true_t)
        assert dev < 1.5 and terr < 0.2, (k, dev, terr)
    # the JAX twin runs the Pallas kernels in interpret mode
    _assert_near_jax(out, jseq.register_sequence(scans, **kw))


def test_icp_patience_returns_best_state(rng):
    from tpuslam_torch.data.synthesis import get_random_rotation_matrix

    base = (rng.random((800, 3), np.float64) * 4).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.1)
    after = (base @ r.T + 0.3).astype(np.float32)
    b, a = pad_cloud(base, device="cpu"), pad_cloud(after, device="cpu")
    ref = icp_register(b, a, max_iterations=40, max_distance_squared=1e6)
    pat = icp_register(b, a, max_iterations=40, max_distance_squared=1e6,
                       divergence_guard=False, patience=3)
    assert float(pat.error) <= float(ref.error) * 1.01 + 1e-8


def test_sequence_stream_matches_batch_lowering(rng):
    scans, poses = _make_trajectory(rng)
    scanned = register_sequence(scans, **KW)
    stream = tpuslam_torch.sequence_stream(scans[0], device="cpu", **KW)
    for s in scans[1:]:
        stream.push(s)
    assert len(stream.absolute) == len(scans)
    for k, (true_r, true_t) in enumerate(poses):
        dev, terr = _pose_error(stream.absolute[k].rotation, stream.absolute[k].translation,
                                true_r, true_t)
        assert dev < 1.0 and terr < 0.15, (k, dev, terr)
    # the same staging and loop as the scan lowering: equal bits
    for k in range(len(scans)):
        np.testing.assert_array_equal(stream.absolute[k].rotation, scanned.absolute[k].rotation)
        np.testing.assert_array_equal(stream.absolute[k].translation,
                                      scanned.absolute[k].translation)


def test_sequence_stream_rejects_oversized_scan(rng):
    scans, _ = _make_trajectory(rng, n_scans=2, n_pts=500)
    stream = SequenceStream(scans[0], device="cpu")
    with pytest.raises(ValueError):
        stream.push(np.zeros((4096, 3), np.float32))


def test_sequence_stream_spatial_arm(rng):
    scans, poses = _make_trajectory(rng, n_scans=3, n_pts=700, step_angle=0.05,
                                    step_trans=0.3)
    kw = dict(max_iterations=40, max_distance_squared=1e6, use_spatial=True)
    stream = SequenceStream(scans[0], device="cpu", **kw)
    jstream = jseq.SequenceStream(scans[0], **kw)
    for s in scans[1:]:
        stream.push(s)
        jstream.push(s)
    dev, terr = _pose_error(stream.absolute[-1].rotation, stream.absolute[-1].translation,
                            poses[-1][0], poses[-1][1])
    assert dev < 1.5 and terr < 0.2, (dev, terr)
    for p, j in zip(stream.absolute, jstream.absolute):
        np.testing.assert_allclose(p.rotation, np.asarray(j.rotation), rtol=0, atol=1e-4)
        np.testing.assert_allclose(p.translation, np.asarray(j.translation), rtol=0, atol=1e-4)


# against the JAX twins --------------------------------------------------------------


@pytest.mark.parametrize("lowering", [
    dict(),  # scan, seeded
    dict(seed_with_previous=False),  # scan, cold
    dict(scan=False),  # per pair
    dict(scan=False, seed_with_previous=False),
    dict(batch=True),
])
def test_lowering_matches_jax(rng, lowering):
    scans, _ = _make_trajectory(rng)
    _assert_near_jax(register_sequence(scans, **lowering, **KW),
                     jseq.register_sequence(scans, **lowering, **KW))


def test_stream_matches_jax_stream(rng):
    scans, _ = _make_trajectory(rng)
    stream = tpuslam_torch.sequence_stream(scans[0], device="cpu", **KW)
    jstream = jseq.SequenceStream(scans[0], **KW)
    for s in scans[1:]:
        rel = stream.push(s)
        jrel = jstream.push(s)
        np.testing.assert_allclose(rel.rotation, np.asarray(jrel.rotation), rtol=0, atol=1e-4)
        np.testing.assert_allclose(rel.translation, np.asarray(jrel.translation), rtol=0,
                                   atol=1e-4)
    for p, j in zip(stream.absolute, jstream.absolute):
        np.testing.assert_allclose(p.rotation, np.asarray(j.rotation), rtol=0, atol=1e-4)
        np.testing.assert_allclose(p.translation, np.asarray(j.translation), rtol=0, atol=1e-4)


@pytest.mark.parametrize("m,count", [(4096, 3000), (2048, 2048)])
def test_presorted_hier_target_equals_jax(rng, m, count):
    pts = np.zeros((m, 3), np.float32)
    pts[:count] = (rng.random((count, 3)) * 10.0 - 4.0).astype(np.float32)
    order = jax_host_morton_order(pts, count)
    np.testing.assert_array_equal(host_morton_order(pts, count), order)
    srt = pts[order]
    jc = jax_pad_cloud(srt, multiple=m)._replace(count=jnp.int32(count))
    want = jax_hier.prepare_hier_target(jc.points, jc.mask(), jc.count, g=128, presorted=True)
    tc = Cloud(torch.from_numpy(srt), torch.tensor(count, dtype=torch.int32))
    got = nn_hier.prepare_hier_target(tc.points, tc.mask(), tc.count, g=128, presorted=True)
    for field in ("packed", "radii", "center_ref", "cmax", "original_points"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_array_equal(got.caug.float().numpy(),
                                  np.asarray(want.caug.astype(jnp.float32)))
    # the packed index of a valid row is its sorted position
    np.testing.assert_array_equal(got.packed[:count, 3].numpy(), np.arange(count))


def test_pair_zero_semantics(rng):
    """The scan lowering's pair 0 runs the seeded loop (patience 8, the
    guard off) from the identity, as the JAX scan does; the per-pair
    lowering's pair 0 runs the cold loop (patience 0, the guard on).  Each
    equals the matching ``icp_register`` call bit for bit, and its JAX twin
    in iterations."""
    scans, _ = _make_trajectory(rng, n_scans=3)
    npad = max(-(-len(s) // 128) * 128 for s in scans)
    b, a = (pad_cloud(s, multiple=npad, device="cpu") for s in scans[:2])
    for lowering, kw in ((dict(), dict(divergence_guard=False, patience=SEED_PATIENCE)),
                         (dict(scan=False), dict())):
        got = register_sequence(scans, **lowering, **KW)
        solo = icp_register(b, a, **kw, **KW)
        np.testing.assert_array_equal(got.relative[0].rotation,
                                      solo.transform.rotation.numpy())
        np.testing.assert_array_equal(got.relative[0].translation,
                                      solo.transform.translation.numpy())
        assert got.iterations[0] == solo.iterations
        want = jseq.register_sequence(scans, **lowering, **KW)
        assert int(want.iterations[0]) == got.iterations[0]


def test_host_arrays_go_to_resolve_device(rng, monkeypatch):
    """Host scans land where ``resolve_device`` puts them: the card, and
    an error where there is none; ``device="cpu"`` keeps them on the
    CPU."""
    seen = []
    real = tpuslam_torch.algorithms.sequence.resolve_device

    def spy(device=None):
        out = real(device)
        seen.append(out)
        return out

    monkeypatch.setattr(tpuslam_torch.algorithms.sequence, "resolve_device", spy)
    scans, _ = _make_trajectory(rng, n_scans=2, n_pts=300)
    tpuslam_torch.register_sequence(scans, device="cpu", max_iterations=3)
    SequenceStream(scans[0], device="cpu")
    assert [d.type for d in seen] == ["cpu", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpuslam_torch.register_sequence(scans, max_iterations=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SequenceStream(scans[0])
