"""Batched multi-pair registration of the PyTorch port
(``tpuslam_torch.algorithms.batch``, ``tpuslam_torch.register_pairs``):
every case of ``tests/test_batch.py`` on the port, each batch held to the
port's solo runs and to the JAX package's batch.

Tolerances, with their reasons:

* batch against the port's solo runs: equal iterations and bit for bit
  where the work per pair is the same: the batched ICP loop on either NN
  arm (the NN kernels and the elementwise work do not depend on the
  batch, the 3x3 products are written out, and the sums over a pair's
  rows run pair by pair), the unrolled lowering, CPD; 1e-5 (JAX's
  tolerance) where the pairs are padded to another size than the solo
  run's, which changes the rows a reduction adds, and for NICP, whose
  batched 3x3 products and eigh round otherwise;
* batch against the JAX package's batch: 1e-4, as the solo parity tests
  (``tests/test_torch_icp.py``, ``tests/test_torch_nicp.py``).
"""

import numpy as np
import pytest
import torch

import tpuslam
import tpuslam_torch
from tests.conftest import make_cloud, random_rigid
from tests.test_batch import make_pairs
from tpuslam.algorithms import batch as jbatch
from tpuslam.algorithms.icp import icp_register_prealigned as jax_prealigned
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam_torch.algorithms.batch import (
    cpd_register_batch,
    icp_register_batch,
    icp_register_prealigned_batch,
    nicp_register_batch,
    stack_clouds,
)
from tpuslam_torch.algorithms.cpd import cpd_register
from tpuslam_torch.algorithms.icp import icp_register, icp_register_prealigned
from tpuslam_torch.algorithms.nicp import nicp_register
from tpuslam_torch.core import types
from tpuslam_torch.core.types import Cloud, pad_cloud
from tpuslam_torch.ops import nn_hier
from tpuslam_torch.ops.nn import nearest_neighbors, nearest_neighbors_batch


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes, and torch's default of a thread per core in each of them
    oversubscribes the cores (the plain K1 here ran ~25x slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(stacked, k):
    return Cloud(stacked.points[k], stacked.count[k])


def _equal(batch, k, solo):
    assert int(batch.iterations[k]) == int(solo.iterations)
    assert torch.equal(batch.transform.rotation[k], solo.transform.rotation)
    assert torch.equal(batch.transform.translation[k], solo.transform.translation)
    assert torch.equal(batch.error[k], solo.error)


def _close(port, jax_res, atol=1e-4):
    np.testing.assert_allclose(port.transform.rotation.numpy(),
                               np.asarray(jax_res.transform.rotation), rtol=0, atol=atol)
    np.testing.assert_allclose(port.transform.translation.numpy(),
                               np.asarray(jax_res.transform.translation), rtol=0, atol=atol * 10)


def _truth_mse(b, rot, tr, r, t):
    return np.mean(np.sum((b @ np.asarray(rot).T + np.asarray(tr) - (b @ r.T + t)) ** 2, -1))


def test_icp_batch_matches_solo(rng):
    befores, afters, truths = make_pairs(rng, [300, 450, 200])
    batch = icp_register_batch(stack_clouds(befores), stack_clouds(afters), max_iterations=30)
    assert batch.iterations.dtype == torch.int32 and batch.iterations.shape == (3,)
    for i, (b, a) in enumerate(zip(befores, afters)):
        solo = icp_register(pad_cloud(b, multiple=512), pad_cloud(a, multiple=512),
                            max_iterations=30)
        np.testing.assert_allclose(batch.transform.rotation[i].numpy(),
                                   solo.transform.rotation.numpy(), atol=1e-5)
        assert int(batch.iterations[i]) == solo.iterations
        r, t = truths[i]
        assert _truth_mse(b, batch.transform.rotation[i], batch.transform.translation[i],
                          r, t) < 1e-3
    want = jbatch.icp_register_batch(jbatch.stack_clouds(befores), jbatch.stack_clouds(afters),
                                     max_iterations=30)
    _close(batch, want)
    np.testing.assert_array_equal(batch.iterations.numpy(), np.asarray(want.iterations))


def test_icp_batch_unrolled_matches_vmapped(rng):
    befores, afters, _ = make_pairs(rng, [300, 450, 200])
    bb, ba = stack_clouds(befores), stack_clouds(afters)
    vmapped = icp_register_batch(bb, ba, max_iterations=30, unroll=False)
    unrolled = icp_register_batch(bb, ba, max_iterations=30, unroll=True)
    for k in range(3):
        _equal(vmapped, k, icp_register(_pair(bb, k), _pair(ba, k), max_iterations=30))
    assert torch.equal(unrolled.transform.rotation, vmapped.transform.rotation)
    assert torch.equal(unrolled.transform.translation, vmapped.transform.translation)
    assert torch.equal(unrolled.iterations, vmapped.iterations)
    assert torch.equal(unrolled.error, vmapped.error)


def test_icp_batch_unrolled_hier_matches_vmapped(rng):
    befores, afters, _ = make_pairs(rng, [300, 450, 200])
    bb, ba = stack_clouds(befores), stack_clouds(afters)
    vmapped = icp_register_batch(bb, ba, max_iterations=12, unroll=False)
    hier = icp_register_batch(bb, ba, max_iterations=12, unroll=True, use_spatial=True)
    # against the dense arm: the hier arm sums in Morton order
    np.testing.assert_allclose(hier.transform.rotation.numpy(),
                               vmapped.transform.rotation.numpy(), atol=1e-4)
    for i, (b, a) in enumerate(zip(befores, afters)):
        solo = icp_register(pad_cloud(b, multiple=512), pad_cloud(a, multiple=512),
                            max_iterations=12, use_spatial=True)
        np.testing.assert_allclose(hier.transform.rotation[i].numpy(),
                                   solo.transform.rotation.numpy(), atol=1e-6)
        np.testing.assert_allclose(hier.transform.translation[i].numpy(),
                                   solo.transform.translation.numpy(), atol=1e-6)
        assert int(hier.iterations[i]) == solo.iterations
    vmapped_hier = icp_register_batch(bb, ba, max_iterations=12, unroll=False, use_spatial=True)
    assert torch.equal(vmapped_hier.transform.rotation, hier.transform.rotation)
    assert torch.equal(vmapped_hier.iterations, hier.iterations)


@pytest.mark.parametrize("use_spatial", [False, True])
def test_batch_vmap_equals_solo_bit_for_bit(rng, use_spatial):
    """``tests/test_batch.py::test_batch_vmap_hier_equals_solo`` on the port,
    on both NN arms: pairs of different live sizes, bit for bit."""
    sizes = [700, 1024, 512]
    befores, afters, _ = make_pairs(rng, sizes, angle=0.15, trans=2.0)
    bb, ba = stack_clouds(befores), stack_clouds(afters)
    kw = dict(eps=0.0, max_distance_squared=1e18, max_iterations=8, divergence_guard=False,
              use_spatial=use_spatial)
    out = icp_register_batch(bb, ba, unroll=False, **kw)
    for k in range(len(sizes)):
        _equal(out, k, icp_register(_pair(bb, k), _pair(ba, k), **kw))


@pytest.mark.parametrize("use_spatial", [False, True])
def test_batch_freezes_stopped_pairs(rng, use_spatial):
    """Pairs that stop at once (an identity pair converges, a far pair has
    no correspondence) or early keep their state while the others step:
    each equals its solo run, bit for bit."""
    n = 1024
    moving = make_cloud(rng, n)
    r, t = random_rigid(rng, 0.3, 1.0)
    befores = [moving, moving, moving, make_cloud(rng, n)]
    afters = [(moving @ r.T + t).astype(np.float32), moving.copy(), moving + 1000.0,
              (befores[3] @ r.T + t).astype(np.float32)]
    bb, ba = stack_clouds(befores), stack_clouds(afters)
    kw = dict(eps=1e-4, max_distance_squared=50.0, max_iterations=25, use_spatial=use_spatial)
    out = icp_register_batch(bb, ba, unroll=False, **kw)
    iters = out.iterations.tolist()
    assert iters[1] == 0 and iters[2] == 0 and max(iters) > 2
    assert float(out.error[2]) == 1e5  # never accepted a step
    if use_spatial:
        assert out.nn is not None and out.nn.prev_target.shape[0] == 4
    for k in range(4):
        _equal(out, k, icp_register(_pair(bb, k), _pair(ba, k), **kw))


def test_nicp_batch_recovers(rng):
    befores, afters, truths = make_pairs(rng, [400, 350], angle=0.3)
    befores = [b * np.array([1.0, 0.5, 0.2], np.float32) for b in befores]
    afters = [(b @ r.T + t).astype(np.float32) for b, (r, t) in zip(befores, truths)]
    batch = nicp_register_batch(stack_clouds(befores), stack_clouds(afters))
    want = jbatch.nicp_register_batch(jbatch.stack_clouds(befores), jbatch.stack_clouds(afters))
    _close(batch, want)
    np.testing.assert_array_equal(batch.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_allclose(batch.error.numpy(), np.asarray(want.error), rtol=1e-4,
                               atol=1e-9)
    for i, (b, (r, t)) in enumerate(zip(befores, truths)):
        assert _truth_mse(b, batch.transform.rotation[i], batch.transform.translation[i],
                          r, t) < 1e-3
        solo = nicp_register(pad_cloud(b), pad_cloud(afters[i]))
        np.testing.assert_allclose(batch.transform.rotation[i].numpy(),
                                   solo.transform.rotation.numpy(), rtol=0, atol=1e-5)
        assert int(batch.iterations[i]) == solo.iterations == 4


def test_cpd_batch_recovers(rng):
    befores, afters, truths = make_pairs(rng, [200, 250], angle=0.2, trans=0.5)
    kw = dict(weight=0.1, max_iterations=60, tolerance=1e-6, const_scale=True)
    bb, ba = stack_clouds(befores), stack_clouds(afters)
    batch = cpd_register_batch(bb, ba, **kw)
    for i, (b, (r, t)) in enumerate(zip(befores, truths)):
        s = float(batch.transform.scale[i])
        rot, tr = batch.transform.rotation[i].numpy(), batch.transform.translation[i].numpy()
        assert np.mean(np.sum((s * (b @ rot.T) + tr - (b @ r.T + t)) ** 2, -1)) < 5e-3
        _equal(batch, i, cpd_register(_pair(bb, i), _pair(ba, i), **kw))


def test_stack_clouds_padding(rng):
    clouds = [rng.random((n, 3)).astype(np.float32) for n in (50, 300)]
    stacked = stack_clouds(clouds)
    assert stacked.points.shape == (2, 384, 3)
    assert stacked.count.tolist() == [50, 300]
    assert stacked.mask().shape == (2, 384) and stacked.mask().sum(1).tolist() == [50, 300]
    with pytest.raises(ValueError, match="empty"):
        stack_clouds([])


def _pairs_for_api(rng, k=3):
    pairs = []
    for i in range(k):
        before = make_cloud(rng, 200 + 40 * i)
        r, t = random_rigid(rng, angle=0.15, trans=0.4)
        pairs.append((before, (before @ r.T + t).astype(np.float32)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("method,kwargs", [
    (tpuslam_torch.ComputationMethod.Icp, {}),
    (tpuslam_torch.ComputationMethod.NoniterativeIcp, {}),
    (tpuslam_torch.ComputationMethod.Cpd, {"max_iterations": 8}),
])
def test_register_pairs_library_api(rng, method, kwargs):
    """``register_pairs`` against per-pair ``register`` (the pairs pad to a
    common size, solo runs to their own: 1e-4) and against the JAX
    package's ``register_pairs`` (1e-4)."""
    befores, afters = _pairs_for_api(rng)
    rots, ts, iters, errs = tpuslam_torch.register_pairs(
        befores, afters, computation_method=method, device="cpu", **kwargs)
    assert rots.shape == (3, 3, 3) and ts.shape == (3, 3)
    assert iters.dtype == np.int32 and errs.shape == (3,)
    for i, (bf, af) in enumerate(zip(befores, afters)):
        r1, t1, it1, _ = tpuslam_torch.register(bf, af, computation_method=method,
                                                device="cpu", **kwargs)
        np.testing.assert_allclose(rots[i], r1, atol=1e-4)
        np.testing.assert_allclose(ts[i], t1, atol=1e-4)
        # solo NICP widens these cube-like clouds (candidates scored); the
        # batch never widens, as in the JAX package
        if method != tpuslam_torch.ComputationMethod.NoniterativeIcp:
            assert int(iters[i]) == it1
    j_method = tpuslam.ComputationMethod(method.value)
    jr, jt, ji, _ = tpuslam.register_pairs(befores, afters, computation_method=j_method,
                                           **kwargs)
    np.testing.assert_allclose(rots, jr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts, jt, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(iters, ji)


def _anisotropic_pairs(rng, sizes, angle=2.0, trans=30.0):
    befores, afters, truths = [], [], []
    for n in sizes:
        b = (rng.random((n, 3)) * 10 * np.array([4, 2, 1])).astype(np.float32)
        r, t = random_rigid(rng, angle=angle, trans=trans)
        befores.append(b)
        afters.append((b @ r.T + t)[rng.permutation(n)].astype(np.float32))
        truths.append((r, t))
    return befores, afters, truths


def test_prealigned_matches_jax(rng):
    (b,), (a,), ((r, t),) = _anisotropic_pairs(rng, [600])
    kw = dict(eps=1e-6, max_distance_squared=1e9, max_iterations=40, seed=2)
    got = icp_register_prealigned(pad_cloud(b), pad_cloud(a), **kw)
    want = jax_prealigned(jax_pad_cloud(b), jax_pad_cloud(a), use_pallas=False, **kw)
    assert got.iterations == int(want.iterations)
    _close(got, want)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-4, atol=1e-9)
    assert _truth_mse(b, got.transform.rotation, got.transform.translation, r, t) < 1e-3
    # the cold loop from identity does not find this pair
    cold = icp_register(pad_cloud(b), pad_cloud(a), eps=1e-6, max_distance_squared=1e9,
                        max_iterations=40)
    assert _truth_mse(b, cold.transform.rotation, cold.transform.translation, r, t) > 1.0
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        icp_register_prealigned(pad_cloud(b), pad_cloud(a), chunk=10)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        icp_register_prealigned(pad_cloud(b), pad_cloud(a), checkpoint_path="x.npz")


def test_prealign_batch_matches_solo(rng):
    befores, afters, truths = _anisotropic_pairs(rng, [300, 450, 200])
    kw = dict(eps=1e-6, max_distance_squared=1e9, max_iterations=40)
    bb, ba = stack_clouds(befores), stack_clouds(afters)
    batch = icp_register_prealigned_batch(bb, ba, **kw)
    unrolled = icp_register_prealigned_batch(bb, ba, unroll=True, **kw)
    assert torch.equal(unrolled.transform.rotation, batch.transform.rotation)
    assert torch.equal(unrolled.iterations, batch.iterations)
    want = jbatch.icp_register_prealigned_batch(jbatch.stack_clouds(befores),
                                                jbatch.stack_clouds(afters), **kw)
    _close(batch, want)
    np.testing.assert_array_equal(batch.iterations.numpy(), np.asarray(want.iterations))
    for i, (b, a) in enumerate(zip(befores, afters)):
        solo = icp_register_prealigned(pad_cloud(b, multiple=512), pad_cloud(a, multiple=512),
                                       **kw)
        np.testing.assert_allclose(batch.transform.rotation[i].numpy(),
                                   solo.transform.rotation.numpy(), atol=1e-5)
        assert int(batch.iterations[i]) == solo.iterations
        r, t = truths[i]
        assert _truth_mse(b, batch.transform.rotation[i], batch.transform.translation[i],
                          r, t) < 1e-3


def test_register_pairs_prealign(rng):
    (b,), (a,), ((r, t),) = _anisotropic_pairs(rng, [400], angle=2.2, trans=35.0)
    config = tpuslam_torch.Configuration(max_iterations=60, max_distance_squared=1e9,
                                         convergence_epsilon=1e-6, icp_prealign=True)
    rots, trs, iters, _ = tpuslam_torch.register_pairs([b, b], [a, a], config, device="cpu")
    for i in range(2):
        assert _truth_mse(b, rots[i], trs[i], r, t) < 1e-3
    solo = tpuslam_torch.register(b, a, config, device="cpu")
    np.testing.assert_allclose(rots[0], solo[0], atol=1e-5)
    assert int(iters[0]) == solo[2]
    jr, _, ji, _ = tpuslam.register_pairs([b, b], [a, a], tpuslam.Configuration(
        max_iterations=60, max_distance_squared=1e9, convergence_epsilon=1e-6,
        icp_prealign=True))
    np.testing.assert_allclose(rots, jr, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(iters, ji)


def test_register_pairs_cpd_honors_all_config_fields(rng):
    befores, afters = _pairs_for_api(rng, 2)
    kwargs = dict(
        computation_method=tpuslam_torch.ComputationMethod.Cpd,
        max_iterations=8,
        cpd_use_fgt=True,
        approximation_type=tpuslam_torch.ApproximationType.Hybrid,
        cpd_centroid_init=True,
        order_of_truncation=6,
    )
    rots, ts, iters, _ = tpuslam_torch.register_pairs(befores, afters, device="cpu", **kwargs)
    for i, (bf, af) in enumerate(zip(befores, afters)):
        r1, t1, it1, _ = tpuslam_torch.register(bf, af, device="cpu", **kwargs)
        np.testing.assert_allclose(rots[i], r1, atol=1e-4)
        np.testing.assert_allclose(ts[i], t1, atol=1e-4)
        assert int(iters[i]) == int(it1)


def test_register_pairs_rejects_mismatched_counts(rng):
    with pytest.raises(ValueError, match="pair count"):
        tpuslam_torch.register_pairs([make_cloud(rng, 10)], [], device="cpu")


def test_nn_batch_front_equals_per_pair(rng):
    """The batched front (K1's batch form) equals the solo front per pair."""
    src = torch.from_numpy(np.stack([make_cloud(rng, 300) for _ in range(3)]))
    tgt = torch.from_numpy(np.stack([make_cloud(rng, 500) for _ in range(3)]))
    count = torch.tensor([500, 123, 0], dtype=torch.int32)
    idx, dist = nearest_neighbors_batch(src, tgt, count)
    for k in range(3):
        i1, d1 = nearest_neighbors(src[k], tgt[k], count[k])
        assert torch.equal(idx[k], i1) and torch.equal(dist[k], d1)


@pytest.mark.parametrize("noise,arm", [(0.02, "fine"), (3.0, "dense")])
def test_hier_batch_equals_solo_queries(rng, noise, arm):
    """The batched hierarchical search equals each pair's solo search bit
    for bit (and, on the fine arm, the dense oracle); the second pair moved
    far from its warm state overflows both budgets and sends the whole
    batch to the dense arm, while alone the first pair takes the fine arm.
    Groups of 256 Morton-sorted sources against 256 tiles of 128 rows."""
    from tpuslam_torch.ops.spatial import morton_permutation

    n, m, gsrc = 2048, 32_768, 256
    targets, states, moved, masks = [], [], [], []
    for k in range(2):
        cloud = pad_cloud(make_cloud(rng, m - 100), multiple=m)
        targets.append(nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count))
        src = torch.from_numpy(make_cloud(rng, n))
        src = src[morton_permutation(src, torch.ones(n)).long()].contiguous()
        idx, _ = nearest_neighbors(src, cloud.points, cloud.count)
        states.append(nn_hier.HierState(cloud.points[idx.long()], torch.tensor(True),
                                        torch.tensor(False)))
        step = noise if k == 1 else 0.02
        moved.append(src + torch.from_numpy(
            (rng.standard_normal((n, 3)) * step).astype(np.float32)))
        masks.append((torch.arange(n) < n - 37 * k).float())
    stack = lambda xs: type(xs[0])(*(torch.stack(f) for f in zip(*xs)))  # noqa: E731
    b_idx, b_dist, b_state = nn_hier.nearest_neighbors_hier_batch(
        torch.stack(moved), torch.stack(masks), stack(targets), stack(states), gsrc=gsrc)
    assert nn_hier.ARM_TRACE[-1] == arm
    assert b_state.sparse.tolist() == [arm != "dense"] * 2
    for k in range(2):
        i1, d1, s1 = nn_hier.nearest_neighbors_hier(moved[k], masks[k], targets[k], states[k],
                                                    gsrc=gsrc)
        assert nn_hier.ARM_TRACE[-1] == ("fine" if k == 0 else arm)
        valid = masks[k] > 0
        assert torch.equal(b_idx[k][valid], i1[valid]) and torch.equal(b_dist[k], d1)
        assert torch.equal(b_state.prev_target[k][valid], s1.prev_target[valid])
        if arm == "fine":
            o_idx, o_dist = nearest_neighbors(moved[k], targets[k].original_points,
                                              targets[k].count)
            assert torch.equal(b_idx[k][valid], o_idx[valid])
            assert torch.equal(b_dist[k][valid], o_dist[valid])


def test_pad_cloud_places_host_arrays_by_resolve_device(rng, monkeypatch):
    """A numpy array goes where ``resolve_device(None)`` says (the card
    when there is one); an explicit device and a tensor's own device
    stand."""
    asked = []

    def fake(device=None):
        asked.append(device)
        return torch.device("meta") if device is None else torch.device(device)

    monkeypatch.setattr(types, "resolve_device", fake)
    pts = make_cloud(rng, 10)
    assert pad_cloud(pts).points.device.type == "meta" and asked == [None]
    assert pad_cloud(pts, device="cpu").points.device.type == "cpu"
    assert pad_cloud(torch.from_numpy(pts)).points.device.type == "cpu"
    monkeypatch.undo()
    assert pad_cloud(pts).points.device == tpuslam_torch.core.device.resolve_device(None)
    assert stack_clouds([pts]).points.device == tpuslam_torch.core.device.resolve_device(None)


def test_icp_checkpoint_env_raises(rng, monkeypatch):
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", "ckpt.npz")
    pts = make_cloud(rng, 64)
    with pytest.raises(NotImplementedError, match="TPUSLAM_ICP_CKPT.*Queue 1 item 2"):
        tpuslam_torch.register(pts, pts, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tpuslam_torch.register(pts, pts, device="cpu", icp_prealign=True)
