"""Kernels K4 (dense CPD E-step) and K5 (block-skipping CPD E-step) of
the PyTorch port against the JAX package, on the CPU.

On the CPU each wrapper runs its plain version:

* K4's plain version (``tpuslam_torch.kernels.cpd_dense``) against
  ``cpd_estep_pallas(interpret=True)`` at the shapes of
  ``tests/test_pallas_cpd.py``, with and without truncation.  The
  Gaussian and its truncation are rounded as XLA rounds them, but the
  sums run in torch's order and ``exp`` is torch's: ``p1`` and ``pt1``
  within 1e-5 relative (1e-7 absolute), ``px`` within 1e-5 relative
  (1e-6 absolute), the log-likelihood within 1e-6 relative;
* K5's plain version (``kernels.cpd_cand``) equal to K4's bit for bit in
  every regime of ``tests/test_pallas_cpd.py``: four sigma^2 settings,
  separated clusters, fat blocks, the checked form;
* K5's admission (bounds, admitted block pairs, counts, fat blocks,
  candidate tables) equal to the JAX package's bit for bit.

The CUDA kernels are held to the plain versions in ``test_torch_cuda.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.kernels.pallas_cpd_cand as jax_cand_mod
from tpuslam.algorithms.cpd import sigma_squared_init as jax_sigma2
from tpuslam.algorithms.cpd import uniform_constant as jax_uniform
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam.kernels.pallas_cpd import cpd_estep_pallas
from tpuslam.ops.spatial import morton_permutation as jax_morton
from tpuslam.ops.spatial import tile_bounds as jax_tile_bounds
from tpuslam_torch.kernels import cpd_cand, cpd_dense

FIELDS = ("p1", "pt1", "px", "error")


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_close_to_jax(got, want):
    np.testing.assert_allclose(got.p1.numpy(), np.asarray(want.p1), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.pt1.numpy(), np.asarray(want.pt1), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.px.numpy(), np.asarray(want.px), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-6)


def _assert_bitwise(a, b, what=""):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{f} differs {what}"


def _jax_problem(before, after, n_moving, n_target, multiple=128):
    cb = jax_pad_cloud(before, multiple=multiple)
    ca = jax_pad_cloud(after, multiple=multiple)
    s2 = jax_sigma2(cb.points, cb.mask(), ca.points, ca.mask())
    c = jax_uniform(s2, jnp.float32(0.3), jnp.float32(n_moving), jnp.float32(n_target))
    return cb, ca, s2, c


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("nm", [(96, 80), (300, 257), (512, 512)])
def test_dense_plain_matches_pallas(rng, nm, truncate):
    n_moving, n_target = nm
    before = (rng.random((n_moving, 3)) * 4.0 - 2.0).astype(np.float32)
    after = (before[:n_target] + 0.25).astype(np.float32)
    cb, ca, s2, c = _jax_problem(before, after, n_moving, n_target)
    args = (cb.points, cb.mask(), ca.points, ca.mask(), s2, c, jnp.asarray(truncate))
    want = cpd_estep_pallas(*args, interpret=True)
    got = cpd_dense.cpd_estep_dense(*(_t(a) for a in args))
    _assert_close_to_jax(got, want)
    assert torch.all(got.p1[n_moving:] == 0) and torch.all(got.pt1[n_target:] == 0)
    assert got.p1.shape == (cb.points.shape[0],) and got.px.shape == (cb.points.shape[0], 3)


def test_dense_plain_internal_padding(rng):
    """Lane-aligned, not tile-aligned: internal padding to 2048 rows with
    a mostly padded second block, ragged valid counts."""
    before = (rng.random((1152, 3)) * 4.0).astype(np.float32)
    after = (rng.random((1280, 3)) * 4.0).astype(np.float32)
    cb, ca, s2, c = _jax_problem(before[:1100], after[:1250], 1100, 1250)
    for trunc in (False, True):
        args = (cb.points, cb.mask(), ca.points, ca.mask(), s2 * 0.05, c,
                jnp.asarray(trunc))
        want = cpd_estep_pallas(*args, interpret=True)
        got = cpd_dense.cpd_estep_dense(*(_t(a) for a in args))
        assert got.p1.shape == want.p1.shape
        _assert_close_to_jax(got, want)


def test_dense_batch_matches_each_pair(rng):
    """The pair axis: a batch of two (different sigma^2, constants,
    truncation flags and valid counts) equals its pairs one by one."""
    mov = torch.from_numpy((rng.random((2, 1500, 3)) * 5).astype(np.float32))
    tgt = torch.from_numpy((rng.random((2, 1100, 3)) * 5).astype(np.float32))
    mm = torch.ones(2, 1500)
    mm[1, 1200:] = 0
    tm = torch.ones(2, 1100)
    tm[0, 1000:] = 0
    s2 = torch.tensor([0.5, 0.08])
    c = torch.tensor([0.3, 0.01])
    tr = torch.tensor([False, True])
    batch = cpd_dense.cpd_estep_dense_batch(mov, mm, tgt, tm, s2, c, tr)
    for p in range(2):
        one = cpd_dense.cpd_estep_dense(mov[p], mm[p], tgt[p], tm[p], s2[p], c[p], tr[p])
        for f in FIELDS:
            assert torch.equal(getattr(batch, f)[p], getattr(one, f)), f


def test_gauss_rounds_as_xla():
    """The plain Gaussian equals the Pallas kernel's term by term: one
    valid moving row (the rest at the sentinel), c = 0 and sigma^2 = 1, so
    each target's denominator is that one term exactly."""
    rng = np.random.default_rng(0)
    tgt = (rng.random((3072, 3)) * 4 - 2).astype(np.float32)
    ty = np.full((1024, 3), cpd_dense.SENTINEL, np.float32)
    ty[0] = (rng.random(3) * 4 - 2).astype(np.float32)
    sc = np.array([[-0.5, 0.0, 0.0, math.log(1e-3)]], np.float32)
    from tpuslam.kernels.pallas_cpd import denom_pass_batch as jax_denom

    want = np.asarray(jax_denom(jnp.asarray(sc), jnp.asarray(ty)[None],
                                jnp.asarray(tgt)[None], True)).reshape(-1)
    ex = jax.jit(lambda e: jnp.exp(e))
    expo = _t(sc)[0, 0] * cpd_dense.fma_sq_dist(_t(tgt), _t(ty[:1]))[:, 0]
    np.testing.assert_array_equal(np.asarray(ex(jnp.asarray(expo.numpy()))), want)
    got = cpd_dense.denom_pass_ref(_t(sc), _t(ty)[None], _t(tgt)[None]).reshape(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_dense_rejects_bad_operands():
    sc = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="multiple of 1024"):
        cpd_dense.denom_pass_batch(sc, torch.zeros(1, 1000, 3), torch.zeros(1, 1024, 3))
    with pytest.raises(TypeError, match="float32"):
        cpd_dense.denom_pass_batch(sc, torch.zeros(1, 1024, 3, dtype=torch.float64),
                                   torch.zeros(1, 1024, 3))
    with pytest.raises(ValueError, match="scalars"):
        cpd_dense.moments_pass_batch(torch.zeros(4), torch.zeros(1, 1024, 3),
                                     torch.zeros(1, 1024, 3), torch.zeros(1, 1024, 4))


def _sorted_pair(rng, m0, n0, big_m, big_n, spread=10.0):
    """Two Morton-sorted padded clouds and their masks (numpy)."""
    mov = np.zeros((big_m, 3), np.float32)
    mov[:m0] = rng.random((m0, 3)) * spread
    tgt = np.zeros((big_n, 3), np.float32)
    tgt[:n0] = rng.random((n0, 3)) * spread
    mm = (np.arange(big_m) < m0).astype(np.float32)
    tm = (np.arange(big_n) < n0).astype(np.float32)
    pm = np.asarray(jax_morton(jnp.asarray(mov), jnp.asarray(mm)))
    pt = np.asarray(jax_morton(jnp.asarray(tgt), jnp.asarray(tm)))
    return mov[pm], mm[pm], tgt[pt], tm[pt]


@pytest.mark.parametrize("s2,trunc", [
    (4.0, False),  # wide mixture: full admission
    (0.05, True),  # the Hybrid truncation window
    (0.002, True),  # tight: heavy skipping
    (0.002, False),  # exact mode: full admission
])
def test_cand_plain_bit_identical_to_dense(rng, s2, trunc):
    mov, mm, tgt, tm = _sorted_pair(rng, 2500, 3000, 3072, 3072)
    args = (_t(mov), _t(mm), _t(tgt), _t(tm), s2, 0.7)
    dense = cpd_dense.cpd_estep_dense(*args, trunc)
    cand = cpd_cand.cpd_estep_cand(*args, torch.tensor(trunc))
    _assert_bitwise(dense, cand, f"s2={s2} trunc={trunc}")


def test_cand_plain_separated_clusters(rng):
    """Two clusters 100 units apart, tight sigma^2: every cross-cluster
    block pair is skipped."""
    half = 1024
    a = (rng.random((half, 3)) * 5).astype(np.float32)
    b = (rng.random((half, 3)) * 5 + 100.0).astype(np.float32)
    mov = np.concatenate([a, b])
    tgt = np.concatenate([a + 0.01, b - 0.01]).astype(np.float32)
    ones = np.ones(2 * half, np.float32)
    pm = np.asarray(jax_morton(jnp.asarray(mov), jnp.asarray(ones)))
    pt = np.asarray(jax_morton(jnp.asarray(tgt), jnp.asarray(ones)))
    args = (_t(mov[pm]), _t(ones), _t(tgt[pt]), _t(ones), 0.01, 0.3, True)
    adm = cpd_cand.block_admission(*args[:4], torch.tensor(0.01), torch.tensor(True))
    assert not bool(adm.adm.all())  # cross-cluster pairs were skipped
    _assert_bitwise(cpd_dense.cpd_estep_dense(*args),
                    cpd_cand.cpd_estep_cand(*args))


def _fat_problem(rng):
    """8 separated clusters of one block each, with moving block 2 and
    target block 5 scrambled across all of them."""
    blocks = []
    for k in range(8):
        center = np.array([100.0 * (k % 4), 100.0 * (k // 4), 0.0], np.float32)
        blocks.append((rng.random((1024, 3)) * 3).astype(np.float32) + center)
    mov = np.concatenate(blocks)
    tgt = np.concatenate([b + 0.01 for b in blocks]).astype(np.float32)
    mov[2 * 1024:3 * 1024] = mov[rng.permutation(8192)[:1024]]
    tgt[5 * 1024:6 * 1024] = tgt[rng.permutation(8192)[:1024]]
    return mov, tgt, np.ones(8192, np.float32)


def test_cand_plain_fat_blocks_bit_identical(rng, monkeypatch):
    """Blocks whose candidate sets overflow the table go through K4's
    passes on their rows: with the slot granule patched to 2 the 5/8 width
    (6) lies between the compact blocks' counts (1) and the scrambled
    ones' (8)."""
    monkeypatch.setattr(cpd_cand, "SLOTS", 2)
    mov, tgt, ones = _fat_problem(rng)
    args = (_t(mov), _t(ones), _t(tgt), _t(ones), 0.05, 0.4, True)
    adm = cpd_cand.block_admission(*args[:4], torch.tensor(0.05), torch.tensor(True))
    assert adm.width_m == 6
    assert adm.fat_n.tolist() == [k == 5 for k in range(8)]
    assert adm.fat_m.tolist() == [k == 2 for k in range(8)]
    assert not bool(adm.overflow)
    _assert_bitwise(cpd_dense.cpd_estep_dense(*args), cpd_cand.cpd_estep_cand(*args))


def test_cand_checked_form(rng):
    """checked=True: the same statistics bits as the unchecked form plus
    an overflow flag, False where the table fits; with truncation off at
    5 blocks the full admission still fits (width 8)."""
    pts = (rng.random((4200, 3)) * 8.0).astype(np.float32)
    c = jax_pad_cloud(pts)
    mask = np.asarray(c.mask())
    perm = np.asarray(jax_morton(c.points, jnp.asarray(mask)))
    mv, mk = _t(np.asarray(c.points)[perm]), _t(mask[perm])
    s2 = float(jax_sigma2(jnp.asarray(mv.numpy()), jnp.asarray(mk.numpy()),
                          jnp.asarray(mv.numpy()), jnp.asarray(mk.numpy()))) * 0.002
    plain = cpd_cand.cpd_estep_cand(mv, mk, mv, mk, s2, 0.01, True)
    checked, ovf = cpd_cand.cpd_estep_cand(mv, mk, mv, mk, s2, 0.01, True, checked=True)
    assert not bool(ovf) and ovf.dtype == torch.bool
    _assert_bitwise(plain, checked)
    wide, ovf_wide = cpd_cand.cpd_estep_cand(mv, mk, mv, mk, s2, 0.01, False, checked=True)
    assert not bool(ovf_wide)
    _assert_bitwise(wide, cpd_dense.cpd_estep_dense(mv, mk, mv, mk, s2, 0.01, False))


def test_cand_checked_overflow_zeroes_counts(rng, monkeypatch):
    """Over the fat budget the checked form flags overflow and its
    statistics carry no block sum (every count zeroed); the unchecked
    form routes to K4.  The flag is a tensor: a host ``False`` would skip
    the admission altogether."""
    monkeypatch.setattr(cpd_cand, "FAT_MAX", 0)
    monkeypatch.setattr(cpd_cand, "SLOTS", 1)
    mov, mm, tgt, tm = _sorted_pair(rng, 4096, 4096, 4096, 4096)
    args = (_t(mov), _t(mm), _t(tgt), _t(tm), 4.0, 0.3, torch.tensor(False))
    out, ovf = cpd_cand.cpd_estep_cand(*args, checked=True)
    assert bool(ovf)
    assert torch.all(out.p1 == 0)  # no moment was accumulated
    _assert_bitwise(cpd_cand.cpd_estep_cand(*args), cpd_dense.cpd_estep_dense(*args))


def _jax_admission_capture(mov, mm, tgt, tm, s2, trunc, monkeypatch):
    """Run the JAX candidate E-step (checked form, interpret mode) and
    capture what it hands ``_build_cand_table``: (admission, counts,
    table) for the denominator and the moments pass."""
    captured = []
    orig = jax_cand_mod._build_cand_table

    def spy(adm, counts, width):
        out = orig(adm, counts, width)
        jax.debug.callback(
            lambda a, c, o: captured.append((np.asarray(a), np.asarray(c), np.asarray(o))),
            adm, counts, out)
        return out

    monkeypatch.setattr(jax_cand_mod, "_build_cand_table", spy)
    jax_cand_mod.cpd_estep_cand.clear_cache()
    try:
        jax.block_until_ready(jax_cand_mod.cpd_estep_cand(
            jnp.asarray(mov), jnp.asarray(mm), jnp.asarray(tgt), jnp.asarray(tm),
            jnp.float32(s2), jnp.float32(0.5), jnp.asarray(trunc),
            interpret=True, checked=True))
    finally:
        jax_cand_mod.cpd_estep_cand.clear_cache()
    return captured


def _clustered_pair(rng):
    """Four clusters of 1,024 rows in four octants of the bounding box (so
    each sorts into one block), on each side, Morton-sorted:
    a fixture whose admission skips block pairs at this small size (on a
    uniform box of a few blocks every pair touches)."""
    centers = np.array([[0, 0, 0], [100, 0, 0], [0, 100, 0], [0, 0, 100]], np.float32)
    mov = np.concatenate([(rng.random((1024, 3)) * 3).astype(np.float32) + c
                          for c in centers])
    tgt = (mov + 0.01).astype(np.float32)[rng.permutation(4096)]
    ones = np.ones(4096, np.float32)
    pm = np.asarray(jax_morton(jnp.asarray(mov), jnp.asarray(ones)))
    pt = np.asarray(jax_morton(jnp.asarray(tgt), jnp.asarray(ones)))
    return mov[pm], ones, tgt[pt], ones


@pytest.mark.parametrize("fixture,s2,trunc", [
    ("uniform", 0.05, True), ("uniform", 0.004, True), ("uniform", 0.05, False),
    ("clusters", 0.05, True), ("clusters", 0.05, False),
])
def test_admission_equals_jax(rng, monkeypatch, fixture, s2, trunc):
    if fixture == "uniform":
        mov, mm, tgt, tm = _sorted_pair(rng, 3000, 4000, 3072, 4096)
    else:
        mov, mm, tgt, tm = _clustered_pair(rng)
    captured = _jax_admission_capture(mov, mm, tgt, tm, s2, trunc, monkeypatch)
    assert len(captured) == 2
    (adm_j, counts_nj, table_mj), (admt_j, counts_mj, table_nj) = captured
    a = cpd_cand.block_admission(_t(mov), _t(mm), _t(tgt), _t(tm),
                                 torch.tensor(s2), torch.tensor(trunc))
    np.testing.assert_array_equal(a.adm.numpy(), adm_j)
    np.testing.assert_array_equal(a.adm.T.numpy(), admt_j)
    overflow = bool(a.overflow)
    for fat, counts, counts_j in ((a.fat_n, a.counts_n, counts_nj),
                                  (a.fat_m, a.counts_m, counts_mj)):
        live = torch.where(fat | overflow, 0, counts)
        np.testing.assert_array_equal(live.numpy(), counts_j)
    # fat blocks: those whose admitted count exceeds the table
    np.testing.assert_array_equal(a.fat_n.numpy(), adm_j.sum(1) > a.width_m)
    np.testing.assert_array_equal(a.fat_m.numpy(), admt_j.sum(1) > a.width_n)
    assert (a.width_m, a.width_n) == (table_mj.shape[1], table_nj.shape[1])
    from tpuslam_torch.ops.nn_hier import _build_cand_table

    np.testing.assert_array_equal(
        _build_cand_table(a.adm, _t(counts_nj), a.width_m).numpy(), table_mj)
    np.testing.assert_array_equal(
        _build_cand_table(a.adm.T, _t(counts_mj), a.width_n).numpy(), table_nj)
    if fixture == "clusters":
        # each cluster admits only itself with truncation on
        assert int(a.adm.sum()) == (4 if trunc else 16)


def test_admission_bound_equals_jax_expression(rng):
    """The block-pair lower bound, as ``pallas_cpd_cand.py:273-282``
    writes it (jitted here, rounded by XLA on the CPU), bit for bit."""
    mov, mm, tgt, tm = _sorted_pair(rng, 3000, 4000, 3072, 4096)

    @jax.jit
    def jax_lb(mov, mm, tgt, tm, s2):
        tb_n = jax_tile_bounds(tgt, tm, 128)
        tb_m = jax_tile_bounds(mov, mm, 128)
        diff = tb_n.centers[:, None, :] - tb_m.centers[None, :, :]
        cdist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        lb = jnp.maximum(cdist - tb_n.radii[:, None] - tb_m.radii[None, :], 0.0
                         ) * jnp.float32(1.0 - 1e-5)
        lb = jnp.min(lb.reshape(4, 8, 3, 8), axis=(1, 3))
        d2 = -jnp.float32(math.log(1e-3)) * 2.0 * s2 * jnp.float32(1.0 + 1e-5)
        return lb, d2

    lb_j, d2_j = jax_lb(jnp.asarray(mov), jnp.asarray(mm), jnp.asarray(tgt),
                        jnp.asarray(tm), jnp.float32(0.0123))
    a = cpd_cand.block_admission(_t(mov), _t(mm), _t(tgt), _t(tm),
                                 torch.tensor(0.0123), torch.tensor(True))
    np.testing.assert_array_equal(a.lb.numpy(), np.asarray(lb_j))
    assert np.float32(cpd_cand.cut_factor(1e-3) * np.float32(0.0123)) == np.asarray(d2_j)


def test_table_width_and_budget_match_jax():
    """Width 5/8 of the blocks in SLOTS granules and the fat budget, as the
    JAX package's at one block per slot (its SMEM cap does not bind up to
    the 376k rung: 368 blocks, cap 356, width 232)."""
    for t in (2, 5, 8, 20, 368):
        cap = max(jax_cand_mod._TABLE_SMEM_BYTES // 4 // t, jax_cand_mod.SLOTS)
        want = -(-min(t, max(5 * t // 8, 1), cap) // 8) * 8
        assert cpd_cand.table_width(t) == want
        assert cpd_cand.fat_budget(t) == jax_cand_mod._fat_budget(t)
    assert cpd_cand.table_width(368) == 232


def _bits(masks):
    """bool[..., SEGS] of an i32 segment mask."""
    return ((masks[..., None] >> torch.arange(cpd_cand.SEGS)) & 1).bool()


def _admission_at(rng, monkeypatch, f_sub, n=4096):
    """A uniform, Morton-sorted pair of ``n`` rows a side and its
    admission, with the sub-tile bound cap patched so that ``f_sub`` is
    the factor taken (4 is the 1.3M rung's)."""
    blocks = n // 1024
    monkeypatch.setattr(cpd_cand, "SUB_BOUND_MAX", (blocks * f_sub) ** 2)
    assert cpd_cand.sub_factor(blocks, blocks) == f_sub
    mov, mm, tgt, tm = _sorted_pair(rng, n, n, n, n)
    return _t(mov), _t(mm), _t(tgt), _t(tm)


@pytest.mark.parametrize("f_sub,rows_per_thread", [(8, 1), (4, 1), (4, 2)])
@pytest.mark.parametrize("s2", [0.05, 0.01, 0.002])
def test_segment_masks_are_sound(rng, monkeypatch, f_sub, rows_per_thread, s2):
    """For every (CTA rows, 128-row segment of the other cloud) that the
    masks drop, on both passes, every Gaussian of the pair is +0.0; and
    some are dropped.  At 4096 rows a side, f_sub 8 and 4, CTAs of 64 and
    128 rows (the 1.3M rung: two CTAs a 256-row sub-tile)."""
    if rows_per_thread == 2:
        monkeypatch.setattr(cpd_dense, "FILL_THREADS", 0)
    mov, mm, tgt, tm = _admission_at(rng, monkeypatch, f_sub)
    a = cpd_cand.block_admission(mov, mm, tgt, tm, torch.tensor(s2), torch.tensor(True))
    assert a.f_sub == f_sub
    cta = cpd_dense.cpd_geometry(4096).cta_rows
    assert cta == 64 * rows_per_thread
    sc = cpd_dense.estep_scalars(torch.tensor([s2]), torch.tensor([0.3]),
                                 torch.tensor([True]), 1e-3)[0]
    for rows, other, sub_adm in ((tgt, mov, a.sub_adm), (mov, tgt, a.sub_adm.T)):
        masks = cpd_cand.segment_masks(sub_adm, f_sub, cta)
        assert masks.shape == (4096 // cta, 4)
        keep = _bits(masks).reshape(masks.shape[0], -1)
        keep = keep.repeat_interleave(cta, 0).repeat_interleave(cpd_cand.SEG_ROWS, 1)
        g = cpd_dense.gauss_tile(rows, other, sc)
        dropped = g[~keep]
        assert dropped.numel() > 0
        assert bool((dropped == 0).all()) and not bool(torch.signbit(dropped).any())
        # pooled over a block's CTAs and segments: today's block admission
        per_block = (masks != 0).reshape(4, 1024 // cta, 4).any(1)
        want = a.adm if sub_adm is a.sub_adm else a.adm.T
        assert torch.equal(per_block, want)


@pytest.mark.parametrize("f_sub", [8, 4])
def test_cta_tables_list_the_nonzero_masks_ascending(rng, monkeypatch, f_sub):
    """Each CTA's table lists, ascending and packed as (block << 8) |
    mask, exactly the blocks whose segment mask is nonzero; CTAs of an
    unserved (fat) block list nothing; dead slots are 0."""
    mov, mm, tgt, tm = _admission_at(rng, monkeypatch, f_sub)
    a = cpd_cand.block_admission(mov, mm, tgt, tm, torch.tensor(0.004), torch.tensor(True))
    cta = cpd_dense.cpd_geometry(4096).cta_rows
    masks = cpd_cand.segment_masks(a.sub_adm, f_sub, cta)
    serve = torch.tensor([True, False, True, True])
    table, counts = cpd_cand.cta_tables(a.sub_adm, f_sub, cta, serve, 4)
    assert table.dtype == torch.int32 and table.shape == (4096 // cta, 4)
    per = 1024 // cta
    for c in range(table.shape[0]):
        want = [(j << 8) | int(masks[c, j]) for j in range(4) if masks[c, j] != 0]
        if not serve[c // per]:
            want = []
        assert int(counts[c]) == len(want)
        assert table[c].tolist() == want + [0] * (4 - len(want))
    assert int(counts.max()) > int(counts[per:2 * per].max()) == 0
    pairs = cpd_cand.visited_pairs(table, counts, cta)
    assert pairs == int(_bits(masks)[torch.cat([torch.arange(per), torch.arange(2 * per, 4 * per)])]
                        .sum()) * cta * cpd_cand.SEG_ROWS


def _fold(g, w=None):
    """The header's fold of one block in plain torch: four accumulators
    over the columns in order (k % 4), each a float32 add (moments: g * w
    + a, the product exact in float64, rounded once to float32), then
    (a0 + a1) + (a2 + a3)."""
    acc = torch.zeros((g.shape[0], 4), dtype=torch.float32)
    for k in range(g.shape[1]):
        if w is None:
            acc[:, k % 4] = acc[:, k % 4] + g[:, k]
        else:
            acc[:, k % 4] = (g[:, k].double() * float(w[k]) + acc[:, k % 4].double()).float()
    return (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3]), acc


@pytest.mark.parametrize("moments", [False, True])
def test_fold_skipping_zero_segments_keeps_every_bit(rng, moments):
    """Segments whose terms are all +0.0 skipped (their columns dropped
    from the fold) leave every accumulator, and so the partial, equal bit
    for bit; weights of both signs and zero weights included."""
    g = torch.from_numpy(np.exp(-rng.random((64, 1024)) * 8).astype(np.float32))
    zero = [1, 4, 5, 7]
    for s in zero:
        g[:, s * 128:(s + 1) * 128] = 0.0
    w = torch.from_numpy((rng.standard_normal(1024) * 3).astype(np.float32))
    w[::7] = 0.0
    w[3::11] = -0.0
    kept = torch.cat([torch.arange(s * 128, (s + 1) * 128) for s in range(8) if s not in zero])
    full, acc_full = _fold(g, w if moments else None)
    skip, acc_skip = _fold(g[:, kept], w[kept] if moments else None)
    assert torch.equal(acc_full, acc_skip) and torch.equal(full, skip)
    assert not bool(torch.signbit(acc_full[acc_full == 0]).any())


def test_exact_mode_goes_to_k4_without_admission(rng, monkeypatch):
    """A host False for the truncation flag (what the CPD loop's exact
    mode passes) runs K4 at once: no admission, route "k4", K4's bits; the
    checked form says no overflow."""
    def no_admission(*args, **kwargs):
        raise AssertionError("the exact mode ran the admission")

    monkeypatch.setattr(cpd_cand, "block_admission", no_admission)
    mov, mm, tgt, tm = _sorted_pair(rng, 2500, 3000, 3072, 3072)
    args = (_t(mov), _t(mm), _t(tgt), _t(tm), 0.05, 0.3)
    cpd_cand.ROUTE_TRACE.clear()
    out = cpd_cand.cpd_estep_cand(*args, False)
    checked, ovf = cpd_cand.cpd_estep_cand(*args, False, checked=True)
    assert list(cpd_cand.ROUTE_TRACE) == ["k4", "k4"] and not bool(ovf)
    dense = cpd_dense.cpd_estep_dense(*args, False)
    _assert_bitwise(out, dense)
    _assert_bitwise(checked, dense)


@pytest.mark.parametrize("s2", [0.05, 0.004])
def test_cand_plain_bit_identical_at_coarser_sub_tiles(rng, monkeypatch, s2):
    """K5's plain version under 256-row sub-tiles (f_sub 4) and 128-row
    CTAs, the 1.3M rung's geometry, equals K4's bit for bit."""
    monkeypatch.setattr(cpd_dense, "FILL_THREADS", 0)
    mov, mm, tgt, tm = _admission_at(rng, monkeypatch, 4)
    args = (mov, mm, tgt, tm, s2, 0.7)
    cpd_cand.ROUTE_TRACE.clear()
    cand = cpd_cand.cpd_estep_cand(*args, torch.tensor(True))
    assert list(cpd_cand.ROUTE_TRACE) == ["k5"]
    _assert_bitwise(cpd_dense.cpd_estep_dense(*args, True), cand)


def _composition(mov, mm, tgt, tm, s2, trunc, checked):
    """K5's plan as ``cpd_estep_cand`` composed it from the admission, the
    per-CTA tables and the fat subsets (the plain version's pieces, called
    one by one): a dict by ``Plan`` field."""
    a = cpd_cand.block_admission(mov, mm, tgt, tm, s2, trunc)
    dense = a.overflow if checked else a.overflow | ~trunc
    n, m = len(tgt), len(mov)
    out = {}
    out["table_m"], out["counts_n"] = cpd_cand.cta_tables(
        a.sub_adm, a.f_sub, cpd_dense.cpd_geometry(n).cta_rows, ~a.fat_n & ~dense, a.width_m)
    out["table_n"], out["counts_m"] = cpd_cand.cta_tables(
        a.sub_adm.T, a.f_sub, cpd_dense.cpd_geometry(m).cta_rows, ~a.fat_m & ~dense, a.width_n)
    for side, fat in (("n", a.fat_n), ("m", a.fat_m)):
        cap = min(cpd_cand.fat_budget(len(fat)), len(fat))
        n_fat = min(int(fat.sum()), cap)
        out[f"rows_{side}"] = cpd_cand._block_rows(fat, cap)
        live = 0 if bool(dense) else n_fat * 1024
        out[f"live_{side}"] = torch.tensor([live], dtype=torch.int32)
        out[f"valid_{side}"] = torch.arange(cap * 1024) < live
    out["route"] = torch.tensor([int(dense)], dtype=torch.int32)
    out["read"] = torch.tensor([int(dense), int(a.fat_n.sum()), int(a.fat_m.sum())])
    out["scalars"] = cpd_dense.estep_scalars(s2.reshape(1), torch.tensor([0.5]),
                                             trunc.reshape(1), 1e-3)
    out["ty"] = torch.where(mm[:, None] > 0, mov, torch.full_like(mov, cpd_dense.SENTINEL))
    out.update(tgt=tgt, mov_mask=mm, tgt_mask=tm)
    return out


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("fixture,s2,trunc", [
    ("uniform", 0.05, True), ("uniform", 0.004, True), ("uniform", 0.05, False),
    ("clusters", 0.05, True), ("clusters", 0.05, False),
])
def test_cand_plan_ref_equals_the_composition(rng, fixture, s2, trunc, checked):
    """The plain plan returns what ``block_admission``, ``cta_tables`` and
    the fat subsets return, over the admission fixtures, in the checked
    and the unchecked forms; the route is the overflow (checked) or the
    overflow or a false truncation flag."""
    if fixture == "uniform":
        mov, mm, tgt, tm = _sorted_pair(rng, 3000, 4000, 3072, 4096)
    else:
        mov, mm, tgt, tm = _clustered_pair(rng)
    ops = [_t(x) for x in (mov, mm, tgt, tm)]
    s2_t, trunc_t = torch.tensor(s2), torch.tensor(trunc)
    plan = cpd_cand.cand_plan(*ops, s2_t, torch.tensor(0.5), trunc_t, checked=checked)
    want = _composition(*ops, s2_t, trunc_t, checked)
    for f in cpd_cand.Plan._fields:
        got = getattr(plan, f)
        assert got.dtype == want[f].dtype and torch.equal(got, want[f]), f
    if not trunc and not checked:
        assert int(plan.route) == 1 and int(plan.counts_n.max()) == 0


@pytest.mark.parametrize("checked", [False, True])
def test_cand_plan_ref_fat_blocks_and_padding(rng, monkeypatch, checked):
    """Fat blocks (``SLOTS`` 2, as the fat-block test) listed first in the
    fat subsets with their live rows; clouds of 8,000 rows padded to
    8,192 (moving rows at the sentinel); the same plan through the
    checked and unchecked forms where nothing overflows."""
    monkeypatch.setattr(cpd_cand, "SLOTS", 2)
    mov, tgt, ones = _fat_problem(rng)
    ops = [_t(x[:8000]) for x in (mov, ones, tgt, ones)]
    plan = cpd_cand.cand_plan(*ops, torch.tensor(0.05), torch.tensor(0.4), torch.tensor(True),
                              checked=checked)
    assert plan.read.tolist() == [0, 1, 1]
    assert plan.rows_n[:1024].tolist() == list(range(5 * 1024, 6 * 1024))
    assert plan.rows_m[:1024].tolist() == list(range(2 * 1024, 3 * 1024))
    assert int(plan.live_n) == int(plan.live_m) == 1024 and int(plan.valid_n.sum()) == 1024
    assert plan.rows_n.shape == (8 * 1024,)  # the capacity: min(FAT_MAX, blocks) blocks
    assert torch.all(plan.ty[8000:] == cpd_dense.SENTINEL) and plan.ty.shape == (8192, 3)
    assert torch.equal(plan.tgt[:8000], ops[2]) and torch.all(plan.tgt[8000:] == 0)
    assert torch.all(plan.tgt_mask[8000:] == 0) and torch.all(plan.mov_mask[:8000] == 1)


def test_cand_plan_checks_its_operands():
    """The plan's operand checks raise as K5's do, before any dispatch:
    shapes and rows (ValueError), dtypes (TypeError), devices
    (ValueError), fewer than two blocks a side; a device that is neither
    the CPU nor CUDA is refused."""
    pts, ones = torch.zeros(4096, 3), torch.ones(4096)
    sc = (torch.tensor(0.1), torch.tensor(0.01), torch.tensor(True))
    with pytest.raises(TypeError, match="float32"):
        cpd_cand.cand_plan(pts.double(), ones, pts, ones, *sc)
    with pytest.raises(ValueError, match=r"\[rows, 3\]"):
        cpd_cand.cand_plan(pts[:, :2], ones, pts, ones, *sc)
    with pytest.raises(ValueError, match="rows"):
        cpd_cand.cand_plan(pts, ones[:2048], pts, ones, *sc)
    with pytest.raises(ValueError, match="trunc_active"):
        cpd_cand.cand_plan(pts, ones, pts, ones, sc[0], sc[1], torch.tensor(1.0))
    with pytest.raises(ValueError, match="one device"):
        cpd_cand.cand_plan(pts, ones, pts.to("meta"), ones, *sc)
    with pytest.raises(ValueError, match="two blocks"):
        cpd_cand.cand_plan(pts[:1000], ones[:1000], pts, ones, *sc)
    meta = [t.to("meta") for t in (pts, ones, pts, ones, *sc)]
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        cpd_cand.cand_plan(*meta)


@pytest.mark.parametrize("predicated", [False, True])
def test_cand_estep_takes_one_plan_a_call(rng, monkeypatch, predicated):
    """``cpd_estep_cand`` builds its plan once a call through ``cand_plan``
    (eager and predicated), and K4's bits come out."""
    calls = []
    orig = cpd_cand.cand_plan

    def spy(*args):
        calls.append(args[-1])  # checked
        return orig(*args)

    monkeypatch.setattr(cpd_cand, "cand_plan", spy)
    mov, mm, tgt, tm = _sorted_pair(rng, 2500, 3000, 3072, 3072)
    args = (_t(mov), _t(mm), _t(tgt), _t(tm), 0.05, 0.7)
    out = cpd_cand.cpd_estep_cand(*args, torch.tensor(True), predicated=predicated)
    assert calls == [False]
    _assert_bitwise(cpd_dense.cpd_estep_dense(*args, True), out)
