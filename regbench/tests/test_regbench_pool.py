"""The seeded surface and the pool: the same for a seed, different across
seeds, and no pair sent twice in a run."""

import json

import numpy as np

import pool as pools
from conftest import BENCH
from harness import Traffic

PROTOCOL = json.loads((BENCH / "configs" / "icp-perf.json").read_text())["protocol"]
BIG = 2**31 + 977  # seeds may exceed 32 signed bits


def test_same_seed_same_pool_and_seeds_differ():
    a = pools.make_pool(BIG, 300, 4, PROTOCOL, "cpu")
    b = pools.make_pool(BIG, 300, 4, PROTOCOL, "cpu")
    c = pools.make_pool(BIG + 1, 300, 4, PROTOCOL, "cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.before, c.before)
    assert not np.array_equal(a.rotation, c.rotation)


def test_pair_is_the_protocol():
    p = pools.make_pool(5, 2000, 3, PROTOCOL, "cpu")
    for i in range(3):
        r, t = p.rotation[i].astype(np.float64), p.translation[i].astype(np.float64)
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
        angle = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))
        np.testing.assert_allclose(angle, 0.2, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(t), 10.0, rtol=1e-6)
        before = p.before[i].astype(np.float64)
        extent = before.max(0) - before.min(0)
        np.testing.assert_allclose(extent.max(), 10.0, rtol=1e-5)
        # after is another subcloud of the same vertex set, moved: not before moved
        unmoved = (p.after[i] - t) @ r
        assert not np.allclose(unmoved, before, atol=1e-3)
        np.testing.assert_allclose(unmoved.mean(0), before.mean(0), atol=0.2)


def test_the_mesh_is_the_smallest_upstream_one_that_holds_n():
    assert [pools.mesh_vertices(PROTOCOL, n) for n in (1, 4000, 14904, 14905, 20000, 100000)] \
        == [14904, 14904, 14904, 35008, 35008, 333536]


def test_both_clouds_are_prefixes_of_one_shuffled_vertex_set():
    # where the mesh has exactly N vertices, each prefix is the whole set:
    # after, moved back, is before's points in another order
    p = pools.make_pool(5, 1500, 2, dict(PROTOCOL, mesh_vertices=[1500]), "cpu")
    for i in range(2):
        unmoved = (p.after[i].astype(np.float64) - p.translation[i]) @ p.rotation[i]
        assert not np.allclose(unmoved, p.before[i], atol=1e-3)  # shuffled
        d2 = ((unmoved[:, None, :] - p.before[i][None, :, :]) ** 2).sum(-1)
        assert d2.min(1).max() < 1e-8  # each point of after is one of before's
        assert len(set(d2.argmin(1))) == 1500  # and no two the same one


def test_no_pair_repeats_in_a_run_past_the_pool():
    sizes = [200, 300]
    made = {n: pools.make_pool(9, n, 3, PROTOCOL, "cpu") for n in sizes}
    traffic = Traffic({"sizes": sizes}, 9, made)
    seen, counts = set(), {n: 0 for n in sizes}
    for _ in range(20):  # past the pool's 3 pairs a size: re-posed pairs
        n, k, p = traffic.next()
        counts[n] += 1
        key = (p.before.tobytes(), p.after.tobytes())
        assert key not in seen
        seen.add(key)
        # a re-posed pair keeps the protocol's angle and length
        angle = np.arccos(np.clip((np.trace(p.rotation.astype(np.float64)) - 1) / 2, -1, 1))
        np.testing.assert_allclose(angle, 0.2, atol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(p.translation), 10.0, rtol=1e-5)
        moved = p.before @ p.rotation.T + p.translation
        assert abs(moved.mean(0) - p.after.mean(0)).max() < 0.3
    assert counts == {200: 10, 300: 10}  # equal shares, round by round
