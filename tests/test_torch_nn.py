"""Kernel K1 of the PyTorch port (``tpuslam_torch.kernels.nn_dense``)
against the JAX package's nearest-neighbour search.

On the CPU the port's wrapper runs its plain version; it must be bit-
identical (``idx`` and ``dist``) to ``tpuslam.ops.nn.nearest_neighbors_ref``
and to the Pallas kernel in interpret mode, in every case below.  The
CUDA kernel is held to the plain version in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuslam.kernels.pallas_nn import (
    nearest_neighbors_pallas,
    nearest_neighbors_pallas_batch,
)
from tpuslam.ops.nn import BIG as JAX_BIG
from tpuslam.ops.nn import nearest_neighbors_ref as jax_nn_ref
from tpuslam_torch.kernels import nn_dense
from tpuslam_torch.ops.nn import BIG, nearest_neighbors, nearest_neighbors_ref


def _jax_both(src, tgt, count):
    """(idx, dist) of the jnp oracle and of the Pallas kernel (interpret)."""
    args = (jnp.asarray(src), jnp.asarray(tgt), jnp.int32(count))
    ref = jax_nn_ref(*args)
    pallas = nearest_neighbors_pallas(*args, interpret=True)
    return [tuple(np.asarray(a) for a in r) for r in (ref, pallas)]


def _port(src, tgt, count):
    idx, dist = nearest_neighbors(
        torch.from_numpy(src), torch.from_numpy(tgt),
        torch.tensor(count, dtype=torch.int32),
    )
    return idx.numpy(), dist.numpy()


def _assert_bit_identical(port, jax_results):
    for idx, dist in jax_results:
        np.testing.assert_array_equal(port[0], idx)
        np.testing.assert_array_equal(port[1], dist)


@pytest.mark.parametrize("n,m,count", [
    (128, 128, 100),  # ragged count
    (300, 1000, 777),  # N, M not multiples of 128
    (1152, 1152, 1100),  # several 1024-row tiles in the Pallas kernel
    (256, 512, 512),  # every target valid
])
def test_plain_bit_identical_to_jax(rng, n, m, count):
    src = (rng.random((n, 3)) * 10).astype(np.float32)
    tgt = (rng.random((m, 3)) * 10).astype(np.float32)
    _assert_bit_identical(_port(src, tgt, count), _jax_both(src, tgt, count))


def test_plain_bit_identical_spread_1000(rng):
    # larger coordinates: the rounding of every fused step matters more
    src = (rng.random((500, 3)) * 1000 - 500).astype(np.float32)
    tgt = (rng.random((700, 3)) * 1000 - 500).astype(np.float32)
    _assert_bit_identical(_port(src, tgt, 650), _jax_both(src, tgt, 650))


def test_planted_ties_first_index_wins(rng):
    # sources on a lattice of pitch 4 make the distances exact: every
    # source has its nearest target three times at distance 1 (a mirror
    # image and a duplicate row), every other target is farther, and the
    # lowest index must win
    src = (rng.integers(-20, 20, size=(200, 3)) * 4).astype(np.float32)
    tgt = np.concatenate([
        src + np.array([1, 0, 0], np.float32),
        src - np.array([1, 0, 0], np.float32),
        src + np.array([1, 0, 0], np.float32),
        (rng.integers(-20, 20, size=(100, 3)) * 4 + 2).astype(np.float32),
    ])
    port = _port(src, tgt, len(tgt))
    _assert_bit_identical(port, _jax_both(src, tgt, len(tgt)))
    np.testing.assert_array_equal(port[1], 1.0)
    assert np.all(port[0] < 400)  # never the later duplicate block


def test_zero_count_gives_no_match(rng):
    src = (rng.random((130, 3)) * 10).astype(np.float32)
    tgt = (rng.random((256, 3)) * 10).astype(np.float32)
    port = _port(src, tgt, 0)
    _assert_bit_identical(port, _jax_both(src, tgt, 0))
    np.testing.assert_array_equal(port[0], 0)
    np.testing.assert_array_equal(port[1], np.float32(3.4e38))
    assert np.float32(BIG) == np.float32(JAX_BIG)


def test_batch_of_two_matches_jax(rng):
    b, n, m = 2, 200, 384
    src = (rng.random((b, n, 3)) * 10).astype(np.float32)
    tgt = (rng.random((b, m, 3)) * 10).astype(np.float32)
    count = np.array([301, 0], np.int32)
    idx, dist = nn_dense.nearest_neighbors_dense_batch(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(count)
    )
    p_idx, p_dist = nearest_neighbors_pallas_batch(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(count), interpret=True
    )
    v_idx, v_dist = jax.vmap(jax_nn_ref)(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(count)
    )
    for ref_idx, ref_dist in ((p_idx, p_dist), (v_idx, v_dist)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(dist.numpy(), np.asarray(ref_dist))


def test_ref_chunking_is_invisible(rng):
    src = torch.from_numpy((rng.random((777, 3)) * 10).astype(np.float32))
    tgt = torch.from_numpy((rng.random((500, 3)) * 10).astype(np.float32))
    count = torch.tensor(450, dtype=torch.int32)
    whole = nearest_neighbors_ref(src, tgt, count, chunk=4096)
    chunked = nearest_neighbors_ref(src, tgt, count, chunk=100)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    src = torch.from_numpy((rng.random((64, 3)) * 10).astype(np.float32))
    before = nn_dense.LAUNCHES
    idx, dist = nearest_neighbors(src, src, torch.tensor(64, dtype=torch.int32))
    assert nn_dense.LAUNCHES == before
    assert torch.equal(idx, torch.arange(64, dtype=torch.int32))
    assert torch.equal(dist, torch.zeros(64))


def test_other_devices_raise():
    src = torch.empty((1, 8, 3), device="meta")
    count = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        nn_dense.nearest_neighbors_dense_batch(src, src, count)


@pytest.mark.parametrize("bad", ["dtype", "count_dtype", "shape", "batch"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    src = torch.zeros((1, 8, 3))
    tgt = torch.zeros((1, 8, 3))
    count = torch.tensor([8], dtype=torch.int32)
    if bad == "dtype":
        src, err = src.double(), TypeError
    elif bad == "count_dtype":
        count, err = count.long(), TypeError
    elif bad == "shape":
        src, err = torch.zeros((1, 8, 4)), ValueError
    else:
        tgt, err = torch.zeros((2, 8, 3)), ValueError
    with pytest.raises(err):
        nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
