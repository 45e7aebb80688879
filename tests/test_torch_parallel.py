"""The sharded layer of the port (``tpuslam_torch.parallel``) against the
JAX package's (``tpuslam.parallel``), every case of
``tests/test_parallel.py`` but the graft dry run and the v5e efficiency
report.

The port runs in gloo worlds of spawned CPU ranks (``launch.run_world``,
each with a process-group timeout, so a broken collective fails a test
rather than hanging the run); one world of 4 ranks runs most cases at
once, a world of 2 runs the dense ICP again.  The JAX package runs on a
4-device sub-mesh of the conftest's 8 CPU devices, so both have the same
world size.  Inputs are made from a seed with numpy.

Tolerances: the sharded NN, the sharded dense ICP against the port's solo
dense ICP, the chunked runs against the whole ones and the pair axis
against ``register_pairs``: bit for bit.  Against the JAX package: the
JAX tests' own (R 1e-4 and t 1e-3 for ICP, R 2e-4 and equal iterations
for CPD, 1e-5 for the E-step statistics, 2e-2 for the FGT arm, whose
union model the port does not keep); the port's sharded FGT arm against
its solo run: equal iterations and R within 2e-4.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam_torch
from tests.conftest import random_rigid
from tpuslam.algorithms.batch import stack_clouds as jax_stack_clouds
from tpuslam.algorithms.cpd import CPDResume as JaxCPDResume
from tpuslam.algorithms.cpd import cpd_estep as jax_cpd_estep
from tpuslam.algorithms.icp import ICPResume as JaxICPResume
from tpuslam.config.configuration import ApproximationType as JaxApprox
from tpuslam.parallel import batch as jbatch
from tpuslam.parallel import cpd as jcpd
from tpuslam.parallel import icp as jicp
from tpuslam.parallel import nicp as jnicp
from tpuslam.parallel.mesh import make_mesh as jax_make_mesh
from tpuslam.parallel.mesh import replicate_cloud as jax_replicate
from tpuslam.parallel.mesh import shard_cloud as jax_shard
from tpuslam_torch.algorithms.cpd import cpd_estep, cpd_register
from tpuslam_torch.algorithms.icp import icp_register
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.interop import to_numpy_state
from tpuslam_torch.ops.nn import nearest_neighbors_ref
from tpuslam_torch.parallel import comm_model, distributed
from tpuslam_torch.parallel.launch import run_cases, run_world
from tpuslam_torch.parallel.nicp import subcloud_indices

CPU = "cpu"
# seconds a collective may wait for a stopped rank before it raises
TIMEOUT = 60.0
WORLD = 4
ICP_KW = dict(max_iterations=30)
CPD_KW = dict(weight=0.1, max_iterations=40, tolerance=1e-6)
CHUNK_ICP_KW = dict(max_iterations=20)
CHUNK_CPD_KW = dict(weight=0.1, max_iterations=20, tolerance=1e-6)
FGT_KW = dict(weight=0.1, max_iterations=60, tolerance=1e-6,
              approximation_type=ApproximationType.Hybrid, use_fgt=True)
PREALIGN_KW = dict(eps=1e-6, max_distance_squared=1e9, max_iterations=50)
# the collective byte models' sizes (tests/test_parallel.py:446-511)
COMM_N, COMM_M, COMM_K = 1024, 2048, 256


def _moved(rng, n, angle, trans, spread=10.0, shuffle=True):
    before = (rng.random((n, 3)) * spread).astype(np.float32)
    r, t = random_rigid(rng, angle=angle, trans=trans)
    after = (before @ r.T + t).astype(np.float32)
    if shuffle:
        after = after[rng.permutation(n)]
    return before, after, r, t


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return jax_make_mesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def data(jmesh):
    """Every case's inputs, from one seed; and the JAX boundary states
    the port's chunked drivers resume from."""
    rng = np.random.Generator(np.random.PCG64(2024))
    d = {}
    d["nn_small"] = ((rng.random((256, 3)) * 10).astype(np.float32),
                     (rng.random((900, 3)) * 10).astype(np.float32))
    d["nn_chunked"] = ((rng.random((4500, 3)) * 10).astype(np.float32),
                       (rng.random((640, 3)) * 10).astype(np.float32))
    d["icp"] = _moved(rng, 500, 0.2, 1.0)
    d["hier"] = _moved(rng, 700, 0.2, 1.0)
    d["chunk"] = _moved(rng, 400, 0.2, 1.0)
    d["cpd"] = _moved(rng, 200, 0.2, 0.4, spread=5.0)
    d["fgt"] = _moved(rng, 256, 0.2, 0.4, spread=5.0)
    aniso = (rng.random((600, 3)).astype(np.float32) - 0.5) * np.array(
        [10.0, 4.0, 1.5], dtype=np.float32)
    r, t = random_rigid(rng, angle=0.4, trans=5.0)
    d["nicp"] = (aniso, (aniso @ r.T + t)[rng.permutation(600)].astype(np.float32), r, t)
    pre = (rng.random((500, 3)) * 10 * np.array([4, 2, 1])).astype(np.float32)
    r, t = random_rigid(rng, angle=2.2, trans=35.0)
    d["prealign"] = (pre, (pre @ r.T + t)[rng.permutation(500)].astype(np.float32), r, t)
    befores, afters = [], []
    for _ in range(8):
        b = (rng.random((300, 3)) * 10).astype(np.float32)
        r, t = random_rigid(rng, angle=0.2, trans=1.0)
        befores.append(b)
        afters.append((b @ r.T + t).astype(np.float32))
    d["pairs"] = (befores, afters)
    d["estep"] = ((rng.random((384, 3)) * 5.0).astype(np.float32),
                  (rng.random((1024, 3)) * 5.0).astype(np.float32))
    d["comm"] = ((rng.random((COMM_N, 3)) * 10).astype(np.float32),
                 (rng.random((COMM_M, 3)) * 10).astype(np.float32))

    # JAX's sharded runs stopped at a chunk boundary (7 iterations)
    before, after = d["chunk"][:2]
    rep, shd = jax_replicate(before, jmesh), jax_shard(after, jmesh)
    part = jicp.icp_register_sharded(rep, shd, jmesh, max_iterations=7)
    d["icp_resume"] = to_numpy_state(JaxICPResume(
        rotation=part.transform.rotation, translation=part.transform.translation,
        error=part.error, done_before=int(part.iterations)))
    part_c = jcpd.cpd_register_sharded(rep, shd, jmesh, weight=0.1, max_iterations=7,
                                       tolerance=1e-6)
    d["cpd_resume"] = to_numpy_state(JaxCPDResume(*part_c.em[:6],
                                                  done_before=int(part_c.iterations)))
    return d


def _cases(d):
    """The 4-rank world's cases: name -> (kind, kwargs)."""
    nicp_b, nicp_a = d["nicp"][:2]
    comm_b, comm_a = d["comm"]
    exact = dict(eps=0.0, divergence_guard=False, max_iterations=5)
    return {
        "nn_small": ("nn", dict(src=d["nn_small"][0], tgt=d["nn_small"][1])),
        "nn_chunked": ("nn", dict(src=d["nn_chunked"][0], tgt=d["nn_chunked"][1])),
        "icp": ("icp", dict(before=d["icp"][0], after=d["icp"][1], **ICP_KW)),
        "hier_dense": ("icp", dict(before=d["hier"][0], after=d["hier"][1],
                                   max_iterations=25)),
        "hier": ("icp", dict(before=d["hier"][0], after=d["hier"][1], max_iterations=25,
                             use_spatial=True, final_nn=True)),
        "icp_whole": ("icp", dict(before=d["chunk"][0], after=d["chunk"][1], **CHUNK_ICP_KW)),
        "icp_chunked": ("icp", dict(before=d["chunk"][0], after=d["chunk"][1], chunk=7,
                                    **CHUNK_ICP_KW)),
        "icp_resumed": ("icp", dict(before=d["chunk"][0], after=d["chunk"][1], chunk=5,
                                    resume=d["icp_resume"], **CHUNK_ICP_KW)),
        "cpd_whole": ("cpd", dict(before=d["chunk"][0], after=d["chunk"][1], **CHUNK_CPD_KW)),
        "cpd_chunked": ("cpd", dict(before=d["chunk"][0], after=d["chunk"][1], chunk=7,
                                    **CHUNK_CPD_KW)),
        "cpd_resumed": ("cpd", dict(before=d["chunk"][0], after=d["chunk"][1], chunk=5,
                                    resume=d["cpd_resume"], **CHUNK_CPD_KW)),
        "cpd": ("cpd", dict(before=d["cpd"][0], after=d["cpd"][1], **CPD_KW)),
        "fgt": ("cpd", dict(before=d["fgt"][0], after=d["fgt"][1], **FGT_KW)),
        "estep": ("estep", dict(moving=d["estep"][0], target=d["estep"][1], sigma2=1.7,
                                constant=0.9, trunc=False)),
        "nicp": ("nicp", dict(before=nicp_b, after=nicp_a, seed=3)),
        "nicp_sub": ("nicp", dict(before=nicp_b, after=nicp_a, seed=5, subcloud_size=256)),
        "prealign": ("icp", dict(before=d["prealign"][0], after=d["prealign"][1],
                                 prealign=True, **PREALIGN_KW)),
        "pairs": ("pairs", dict(befores=d["pairs"][0], afters=d["pairs"][1],
                                max_iterations=25)),
        "comm_icp": ("icp", dict(before=comm_b, after=comm_a, **exact)),
        "comm_cpd": ("cpd", dict(before=comm_b, after=comm_a, weight=0.1, max_iterations=5,
                                 tolerance=0.0)),
        "comm_nicp": ("nicp", dict(before=comm_b, after=comm_a, subcloud_size=COMM_K)),
        "modules": ("modules", {}),
    }


@pytest.fixture(scope="module")
def world(data):
    """One 4-rank gloo world on the CPU running every case: name ->
    (rank 0's case record, every rank's)."""
    cases = _cases(data)
    rank0, ranks = run_world(run_cases, WORLD, "gloo", CPU, TIMEOUT, list(cases.values()))
    return {name: (rank0[i], [r[i] for r in ranks]) for i, name in enumerate(cases)}


def _res(world, name):
    return world[name][0]["result"]


def _ranks_equal(world, name, keys=("rotation", "translation", "iterations", "error")):
    first = _res(world, name)
    for rec in world[name][1]:
        for k in keys:
            np.testing.assert_array_equal(rec["result"][k], first[k], err_msg=f"{name}: {k}")


def _solo_dense(before, after, **kw):
    return icp_register(pad_cloud(before, device=CPU), pad_cloud(after, device=CPU),
                        use_spatial=False, **kw)


def _equal_solo(got, solo):
    np.testing.assert_array_equal(got["rotation"], solo.transform.rotation.numpy())
    np.testing.assert_array_equal(got["translation"], solo.transform.translation.numpy())
    np.testing.assert_array_equal(got["error"], solo.error.numpy())
    assert int(got["iterations"]) == int(solo.iterations)


# -- sharded NN ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["nn_small", "nn_chunked"])
def test_sharded_nn_matches_reference(world, data, jmesh, name):
    from jax.sharding import PartitionSpec as P

    from tpuslam.parallel.nn import sharded_nn_combine as jax_combine

    src, tgt = data[name]
    got = _res(world, name)
    cloud = pad_cloud(tgt, device=CPU)
    ref_idx, ref_dist = nearest_neighbors_ref(torch.from_numpy(src), cloud.points, cloud.count)
    np.testing.assert_array_equal(got["index"], ref_idx.numpy())
    np.testing.assert_array_equal(got["dist"], ref_dist.numpy())
    np.testing.assert_array_equal(got["matched"], tgt[got["index"]])
    shd = jax_shard(tgt, jmesh)
    fn = jax.jit(jax.shard_map(
        lambda s, t, c: jax_combine(s, t, c), mesh=jmesh,
        in_specs=(P(), P("points", None), P()), out_specs=(P(), P(), P()), check_vma=False))
    gidx, dist, matched = fn(jnp.asarray(src), shd.points, shd.count)
    np.testing.assert_array_equal(got["index"], np.asarray(gidx))
    np.testing.assert_array_equal(got["dist"], np.asarray(dist))
    np.testing.assert_array_equal(got["matched"], np.asarray(matched))
    for rec in world[name][1]:
        np.testing.assert_array_equal(rec["result"]["index"], got["index"])


# -- ICP ----------------------------------------------------------------------


def test_sharded_icp_matches_single_device(world, data, jmesh):
    before, after, r, t = data["icp"]
    got = _res(world, "icp")
    _equal_solo(got, _solo_dense(before, after, **ICP_KW))
    _ranks_equal(world, "icp")
    want = jicp.icp_register_sharded(jax_replicate(before, jmesh), jax_shard(after, jmesh),
                                     jmesh, **ICP_KW)
    np.testing.assert_allclose(got["rotation"], np.asarray(want.transform.rotation), atol=1e-4)
    np.testing.assert_allclose(got["translation"], np.asarray(want.transform.translation),
                               atol=1e-3)
    mse = np.mean(np.sum((before @ got["rotation"].T + got["translation"]
                          - (before @ r.T + t)) ** 2, -1))
    assert mse < 1e-3


def test_sharded_icp_hier_matches_dense_arm(world, data):
    """The per-block hierarchical search inside the sharded loop: its
    final-state NN is the whole cloud's, index for index, and the run
    agrees with the dense arm to float32 rounding of the Morton-ordered
    Procrustes sums."""
    before, after, r, _ = data["hier"]
    hier, dense = _res(world, "hier"), _res(world, "hier_dense")
    assert abs(int(hier["iterations"]) - int(dense["iterations"])) <= 2
    np.testing.assert_allclose(hier["rotation"], dense["rotation"], atol=1e-3)
    np.testing.assert_allclose(hier["translation"], dense["translation"], atol=1e-2)
    np.testing.assert_allclose(hier["rotation"], r, atol=1e-2)
    valid = hier["final_mask"] > 0
    cloud = pad_cloud(after, device=CPU)
    ref_idx, ref_dist = nearest_neighbors_ref(torch.from_numpy(hier["final_src"]),
                                              cloud.points, cloud.count)
    np.testing.assert_array_equal(hier["final_index"][valid], ref_idx.numpy()[valid])
    np.testing.assert_array_equal(hier["final_dist"][valid], ref_dist.numpy()[valid])
    _ranks_equal(world, "hier")


def test_sharded_chunked_matches_unchunked(world):
    for whole, parts in (("icp_whole", "icp_chunked"), ("cpd_whole", "cpd_chunked")):
        w, p = _res(world, whole), _res(world, parts)
        assert int(p["iterations"]) == int(w["iterations"])
        np.testing.assert_array_equal(p["rotation"], w["rotation"])
        np.testing.assert_array_equal(p["translation"], w["translation"])
        np.testing.assert_array_equal(p["error"], w["error"])


def test_chunked_resumes_from_jax_boundary(world, data, jmesh):
    """The port's chunked drivers started from a JAX sharded run's
    boundary state (``interop``) follow JAX's whole run."""
    before, after = data["chunk"][:2]
    rep, shd = jax_replicate(before, jmesh), jax_shard(after, jmesh)
    want = jicp.icp_register_sharded(rep, shd, jmesh, **CHUNK_ICP_KW)
    got = _res(world, "icp_resumed")
    assert int(got["iterations"]) == int(want.iterations)
    np.testing.assert_allclose(got["rotation"], np.asarray(want.transform.rotation), atol=1e-4)
    np.testing.assert_allclose(got["translation"], np.asarray(want.transform.translation),
                               atol=1e-3)
    want_c = jcpd.cpd_register_sharded(rep, shd, jmesh, **CHUNK_CPD_KW)
    got_c = _res(world, "cpd_resumed")
    assert int(got_c["iterations"]) == int(want_c.iterations)
    np.testing.assert_allclose(got_c["rotation"], np.asarray(want_c.transform.rotation),
                               atol=2e-4)


def test_sharded_icp_prealigned_recovers_large_motion(world, data, jmesh):
    before, after, r, t = data["prealign"]
    got = _res(world, "prealign")
    want = jicp.icp_register_sharded_prealigned(
        jax_replicate(before, jmesh), jax_shard(after, jmesh), jmesh, **PREALIGN_KW)
    np.testing.assert_allclose(got["rotation"], np.asarray(want.transform.rotation), atol=1e-4)
    mse = np.mean(np.sum((before @ got["rotation"].T + got["translation"]
                          - (before @ r.T + t)) ** 2, -1))
    assert mse < 1e-3
    _ranks_equal(world, "prealign")


# -- CPD ----------------------------------------------------------------------


def test_sharded_cpd_matches_jax(world, data, jmesh):
    before, after = data["cpd"][:2]
    got = _res(world, "cpd")
    want = jcpd.cpd_register_sharded(jax_replicate(before, jmesh), jax_shard(after, jmesh),
                                     jmesh, **CPD_KW)
    assert int(got["iterations"]) == int(want.iterations)
    np.testing.assert_allclose(got["rotation"], np.asarray(want.transform.rotation), atol=2e-4)
    # the final sigma^2 is tiny and chaotic in float32 summation order
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=0.25, atol=1e-5)
    _ranks_equal(world, "cpd")


def test_sharded_cpd_fgt_recovers_and_matches_jax(world, data, jmesh):
    before, after, r, _ = data["fgt"]
    got = _res(world, "fgt")
    kw = dict(FGT_KW, approximation_type=JaxApprox.Hybrid)
    want = jcpd.cpd_register_sharded(jax_replicate(before, jmesh), jax_shard(after, jmesh),
                                     jmesh, **kw)
    np.testing.assert_allclose(got["rotation"], r, atol=2e-2)
    np.testing.assert_allclose(got["rotation"], np.asarray(want.transform.rotation), atol=2e-2)
    # the port's sharded FGT reproduces its solo run's model, so the runs
    # agree as closely as the exact E-step's do
    solo = cpd_register(pad_cloud(before, device=CPU), pad_cloud(after, device=CPU), **FGT_KW)
    assert int(got["iterations"]) == int(solo.iterations)
    np.testing.assert_allclose(got["rotation"], solo.transform.rotation.numpy(), atol=2e-4)
    _ranks_equal(world, "fgt")


def test_sharded_estep_stats_match_tightly(world, data, jmesh):
    """The sharded E-step's reduced statistics against the solo E-step
    (the port's and the JAX package's) within 1e-5."""
    from jax.sharding import PartitionSpec as P

    moving, target = data["estep"]
    got = _res(world, "estep")
    full = cpd_estep(torch.from_numpy(moving), torch.ones(384), torch.from_numpy(target),
                     torch.ones(1024), 1.7, 0.9, False)
    want = {
        "p1": full.p1.numpy(), "px": full.px.numpy(), "error": full.error.numpy(),
        "t_pt1_a2": float(torch.sum(full.pt1 * torch.sum(torch.from_numpy(target) ** 2, -1))),
        "s_pt1_a": (full.pt1 @ torch.from_numpy(target)).numpy(),
    }

    def local(tgt_shard):
        loc = jax_cpd_estep(jnp.asarray(moving), jnp.ones((384,), jnp.float32), tgt_shard,
                            jnp.ones((tgt_shard.shape[0],), jnp.float32), jnp.float32(1.7),
                            jnp.float32(0.9), jnp.asarray(False))
        return (jax.lax.psum(loc.p1, "points"), jax.lax.psum(loc.px, "points"),
                jax.lax.psum(loc.error, "points"))

    jp1, jpx, jerr = jax.jit(jax.shard_map(
        local, mesh=jmesh, in_specs=(P("points", None),), out_specs=(P(), P(), P()),
        check_vma=False))(jnp.asarray(target))
    for ref in (want, {"p1": np.asarray(jp1), "px": np.asarray(jpx),
                       "error": np.asarray(jerr)}):
        np.testing.assert_allclose(got["p1"], ref["p1"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["px"], ref["px"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(got["error"]), float(ref["error"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["t_pt1_a2"]), want["t_pt1_a2"], rtol=1e-5)
    np.testing.assert_allclose(got["s_pt1_a"], want["s_pt1_a"], rtol=1e-5, atol=1e-5)


# -- NICP ---------------------------------------------------------------------


def test_sharded_nicp_recovers(world, data, jmesh):
    before, after, r, t = data["nicp"]
    got = _res(world, "nicp")
    assert np.linalg.det(got["rotation"]) == pytest.approx(1.0, abs=1e-3)
    mse = np.mean(np.sum((before @ got["rotation"].T + got["translation"]
                          - (before @ r.T + t)) ** 2, -1))
    assert mse < 1e-3
    assert int(got["iterations"]) == 4
    _ranks_equal(world, "nicp")


@pytest.mark.parametrize("name,seed,k", [("nicp", 3, 1000), ("nicp_sub", 5, 256)])
def test_sharded_nicp_matches_jax(world, data, jmesh, name, seed, k):
    """The same candidate and the same subcloud error: the PCG64 subcloud
    is JAX's draw, row for row (``parallel/nicp.py:112-119``)."""
    before, after = data["nicp"][:2]
    got = _res(world, name)
    want = jnicp.nicp_register_sharded(jax_replicate(before, jmesh), jax_shard(after, jmesh),
                                       jmesh, subcloud_size=k, seed=seed)
    assert int(got["iterations"]) == int(want.iterations)
    np.testing.assert_allclose(got["rotation"], np.asarray(want.transform.rotation), atol=1e-4)
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=1e-4, atol=1e-9)
    # the draw as the JAX package writes it
    n_valid, kk = len(before), min(k, 640)
    draw = (np.random.Generator(np.random.PCG64(seed)).permutation(n_valid)[:kk]
            if n_valid > kk else np.arange(kk))
    np.testing.assert_array_equal(subcloud_indices(n_valid, kk, seed), draw.astype(np.int32))


# -- pair axis ----------------------------------------------------------------


def test_pairs_sharded_matches_batch(world, data, jmesh):
    befores, afters = data["pairs"]
    got = _res(world, "pairs")
    want = jbatch.icp_register_pairs_sharded(
        jbatch.shard_pairs(jax_stack_clouds(befores), jmesh),
        jbatch.shard_pairs(jax_stack_clouds(afters), jmesh), jmesh, max_iterations=25)
    np.testing.assert_allclose(got["rotation"], np.asarray(want.transform.rotation), atol=1e-5)
    np.testing.assert_array_equal(got["iterations"], np.asarray(want.iterations))
    rot, trans, iters, errs = tpuslam_torch.register_pairs(befores, afters, device=CPU,
                                                           max_iterations=25)
    np.testing.assert_array_equal(got["rotation"], rot)
    np.testing.assert_array_equal(got["translation"], trans)
    np.testing.assert_array_equal(got["iterations"], iters)
    np.testing.assert_array_equal(got["error"], errs)
    _ranks_equal(world, "pairs")


def test_shard_pairs_needs_a_divisible_batch():
    from tpuslam_torch.algorithms.batch import stack_clouds
    from tpuslam_torch.parallel.batch import shard_pairs
    from tpuslam_torch.parallel.mesh import Mesh

    mesh = Mesh(group=None, rank=0, size=4, device=torch.device(CPU))
    clouds = stack_clouds([np.zeros((4, 3), np.float32)] * 6, device=CPU)
    with pytest.raises(ValueError, match="must divide the 4-rank world"):
        shard_pairs(clouds, mesh)


# -- the collective byte models -----------------------------------------------


def test_comm_model_matches_logged_collectives(world):
    """The byte models equal the collectives the port issues, per loop
    iteration (the JAX package checks its traced program the same way,
    ``tests/test_parallel.py:446-511``).  On the CPU the loops run whole
    chunks of ``LOOP_CHUNK`` iterations, and an iteration frozen past the
    cap runs its collectives too: 5 iterations run 6 at a chunk of 2."""
    from tpuslam_torch.algorithms.device_loop import LOOP_CHUNK

    icp_log = world["comm_icp"][0]["collectives"]
    steps = int(_res(world, "comm_icp")["iterations"])
    assert steps == 5
    per_icp = comm_model.icp_comm_bytes(COMM_N)
    ran = comm_model.logged_iterations(icp_log, per_icp["n_collectives"])
    assert ran == [per_icp["total"]] * (-(-steps // LOOP_CHUNK) * LOOP_CHUNK)
    assert [c.op for c in icp_log[:3]] == ["pmin", "pmin", "psum"]

    cpd_log = world["comm_cpd"][0]["collectives"]
    iters = int(_res(world, "comm_cpd")["iterations"])
    assert iters == 5
    init = comm_model.cpd_init_comm_bytes()
    per = comm_model.cpd_comm_bytes(COMM_N)
    assert comm_model.total_collective_bytes(cpd_log[:init["n_collectives"]]) == init["total"]
    ran = comm_model.logged_iterations(cpd_log, per["n_collectives"], init["n_collectives"])
    assert ran == [per["total"]] * (-(-iters // LOOP_CHUNK) * LOOP_CHUNK)

    nicp_log = world["comm_nicp"][0]["collectives"]
    want = comm_model.nicp_comm_bytes(COMM_K)
    assert comm_model.total_collective_bytes(nicp_log) == want["total"]
    assert len(nicp_log) == want["n_collectives"]


def test_comm_model_matches_logged_fgt_iterations(world, data):
    """A Hybrid run with the FGT: after the set-up's all_gather and three
    psums, each EM iteration's collectives are the FGT model's or the exact
    model's, fast phase first, with at least one iteration of each phase
    that ran (frozen iterations run their collectives too)."""
    from tpuslam_torch.ops.fgt import pd_size

    rec = world["fgt"][0]
    m_pad = len(pad_cloud(data["fgt"][0], device=CPU).points)
    want = {"fgt": comm_model.cpd_fgt_comm_bytes(128, pd_size(8))["total"],
            "exact": comm_model.cpd_comm_bytes(m_pad)["total"]}
    assert [c.op for c in rec["collectives"][:4]] == ["all_gather", "psum", "psum", "psum"]
    ran = comm_model.logged_cpd_iterations(rec["collectives"], 4)
    assert all(b == want[kind] for kind, b in ran), ran
    kinds = [kind for kind, _ in ran]
    assert kinds == sorted(kinds, key=("fgt", "exact").index)
    phases = rec["phases"]
    assert phases.count("fgt") <= kinds.count("fgt") and phases.count("fgt") > 0
    assert phases.count("trunc") <= kinds.count("exact") and phases.count("trunc") > 0


def test_comm_model_formulas():
    assert comm_model.allreduce_seconds(1e9, 1, 1e11) == 0.0
    assert comm_model.allreduce_seconds(1e9, 4, 1e11) == pytest.approx(2 * 1e9 * 3 / 4 / 1e11)
    e = comm_model.predicted_efficiency(20 * 102_400, 3, 0.004, 4, 1e11, 5e-6)
    assert 0.0 < e < 1.0


# -- worlds, backends and guards ----------------------------------------------


def test_two_rank_world_dense_icp_equals_solo(data):
    """A world of 2: the sharded dense ICP is the solo run, bit for bit."""
    before, after = data["icp"][:2]
    rank0, ranks = run_world(run_cases, 2, "gloo", CPU, TIMEOUT,
                             [("icp", dict(before=before, after=after, **ICP_KW)),
                              ("nn", dict(src=data["nn_small"][0], tgt=data["nn_small"][1]))])
    _equal_solo(rank0[0]["result"], _solo_dense(before, after, **ICP_KW))
    for rec in ranks:
        np.testing.assert_array_equal(rec[0]["result"]["rotation"],
                                      rank0[0]["result"]["rotation"])
    src, tgt = data["nn_small"]
    cloud = pad_cloud(tgt, device=CPU)
    ref_idx, _ = nearest_neighbors_ref(torch.from_numpy(src), cloud.points, cloud.count)
    np.testing.assert_array_equal(rank0[1]["result"]["index"], ref_idx.numpy())
    assert [c.op for c in rank0[0]["collectives"][:3]] == ["pmin", "pmin", "psum"]


def test_rank_failure_raises_before_the_timeout():
    """A rank that raises before its first collective, while the others
    wait in a ``psum``: ``run_world`` raises that rank's error in the
    parent, well within the process-group timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fault injected on rank 1"):
        run_world(run_cases, WORLD, "gloo", CPU, TIMEOUT, [("fault", dict(rank=1))])
    assert time.perf_counter() - t0 < TIMEOUT


def test_world_children_import_no_jax(world):
    mods = _res(world, "modules")["modules"]
    assert "tpuslam_torch" in mods and "torch" in mods
    assert not {"jax", "jaxlib", "tpuslam", "tests"} & set(mods), mods


def test_run_world_takes_only_entries_of_the_layer():
    with pytest.raises(ValueError, match="tpuslam_torch.parallel"):
        run_world(print, 2, "gloo", CPU, TIMEOUT)


def test_default_backend_refuses_shared_cards(monkeypatch):
    """``backend=None`` is NCCL, one card a rank; two ranks on one card
    raise and name gloo rather than picking it for the caller."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        distributed.initialize(backend=None, init_method="file:///nonexistent",
                               world_size=2, rank=0)
    assert distributed.resolve_backend(None, 1) == "nccl"
    assert distributed.resolve_backend("gloo", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match='backend="gloo"'):
        distributed.resolve_backend(None, 1)
