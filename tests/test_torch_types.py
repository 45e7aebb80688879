"""Types, devices, copied numpy layers and state interop of the PyTorch
port, against the JAX package.

The config, loader and synthesis modules are copies (importing the
originals imports JAX); they must give bit-identical results on the same
inputs, since both sides are numpy.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import make_cloud
from tpuslam.config import configuration as jax_configuration
from tpuslam.core import types as jax_types
from tpuslam.data import loader as jax_loader
from tpuslam.data import synthesis as jax_synthesis
from tpuslam_torch.config import configuration
from tpuslam_torch.core import types
from tpuslam_torch.core.device import resolve_device
from tpuslam_torch.data import loader, synthesis
from tpuslam_torch.interop import from_numpy_state, to_numpy_state

# the port runs on the card unless asked for the CPU; these tests ask
CPU = "cpu"


@pytest.fixture
def same_search_roots(monkeypatch):
    """Both loaders look in the same places, so they see the same files."""
    monkeypatch.setattr(loader, "SEARCH_ROOTS", list(jax_loader.SEARCH_ROOTS))


# -- core types ---------------------------------------------------------------


@pytest.mark.parametrize("n,multiple", [(0, 128), (1, 128), (130, 128), (300, 512)])
def test_pad_cloud_matches_jax(rng, n, multiple):
    pts = make_cloud(rng, n)
    ours = types.pad_cloud(pts, multiple=multiple, device=CPU)
    ref = jax_types.pad_cloud(pts, multiple=multiple)
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(ref.points))
    assert ours.count.dtype == torch.int32 and ours.count.dim() == 0
    assert int(ours.count) == int(ref.count) == n
    np.testing.assert_array_equal(ours.mask().numpy(), np.asarray(ref.mask()))
    np.testing.assert_array_equal(types.unpad(ours), jax_types.unpad(ref))
    assert ours.padded_size == ref.padded_size


def test_pad_cloud_devices_and_validation(rng):
    pts = make_cloud(rng, 10)
    cloud = types.pad_cloud(torch.from_numpy(pts))
    assert cloud.points.device.type == "cpu" == cloud.count.device.type
    meta = types.pad_cloud(pts, device="meta")
    assert meta.points.device.type == "meta" == meta.count.device.type
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        types.pad_cloud(np.zeros((4, 2), np.float32))


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 102400])
def test_round_up_and_pick_block_match_jax(n):
    assert types.round_up(n) == jax_types.round_up(n)
    assert types.round_up(n, 1024) == jax_types.round_up(n, 1024)
    assert types.pick_block(n) == jax_types.pick_block(n)
    assert types.LANE == jax_types.LANE


def test_identity_transform():
    ident = types.RigidTransform.identity()
    ref = jax_types.RigidTransform.identity()
    for ours, theirs in zip(ident, ref):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


# -- devices ------------------------------------------------------------------


def test_resolve_device_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(torch.device("cuda", 0))
    # no device named is the card, never the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


# -- config copy --------------------------------------------------------------


def test_configuration_copy_matches_original():
    ours = {f.name: f for f in dataclasses.fields(configuration.Configuration)}
    ref = {
        f.name: f for f in dataclasses.fields(jax_configuration.Configuration)
    }
    assert list(ours) == list(ref)
    for name in ours:
        assert repr(ours[name].default) == repr(ref[name].default), name
    for enum_name in ("ComputationMethod", "ExecutionPolicy", "ApproximationType"):
        ours_enum = getattr(configuration, enum_name)
        ref_enum = getattr(jax_configuration, enum_name)
        assert [(e.name, e.value) for e in ours_enum] == [
            (e.name, e.value) for e in ref_enum
        ]


def test_configuration_print_matches_original(capsys):
    ours = configuration.Configuration(max_iterations=7, cloud_spread=2.0)
    ref = jax_configuration.Configuration(max_iterations=7, cloud_spread=2.0)
    assert ours.print() == ref.print()


# -- loader copy --------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "synthetic://2048", "synthetic://300?lattice=1", "synthetic://1",
    "synthetic://0", "synthetic://-5", "synthetic://abc",
])
def test_synthetic_clouds_bit_identical(same_search_roots, spec):
    ours, ref = loader.load_cloud(spec), jax_loader.load_cloud(spec)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_synthetic_fixture_names_what_is_built(same_search_roots):
    has_bunny = len(jax_loader.load_cloud("data/bunny.obj")) > 0
    assert loader.synthetic_fixture() == (
        "tiled-bunny" if has_bunny else "uniform-box"
    )


def test_obj_and_off_readers_bit_identical(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text(
        "v 0 0 0\nv 1.5 0 0\nv 0 2.25 0\nv 1 1 -1\n"
        "f 1 2 3\nf 2/1 3/1 4/1\nf -1//1 -2//1 -3//1\n"
    )
    off = tmp_path / "pts.off"
    off.write_text("OFF\n# comment\n3 0 0\n1 2 3\n\n4 5 6 # tail\n7 8 9.5\n")
    bad = tmp_path / "bad.off"
    bad.write_text("OFF 99999999 0 0\n1 2 3\n")
    # the JAX package's Python readers (both packages' load_cloud may take
    # their native C++ readers instead, which equal them)
    for path, ref in ((obj, jax_loader._load_obj_python),
                      (off, jax_loader._load_off), (bad, jax_loader._load_off)):
        np.testing.assert_array_equal(loader.load_cloud(str(path)), ref(str(path)))
    assert loader.load_cloud(str(tmp_path / "missing.obj")).shape == (0, 3)
    assert loader.load_cloud(str(obj)).shape == (9, 3)
    assert loader.load_cloud(str(bad)).shape == (1, 3)


def test_unported_format_loads_empty(tmp_path, capsys):
    # every format of the JAX package is ported; any other loads empty, loudly
    other = tmp_path / "cloud.3ds"
    other.write_text("3ds\n")
    assert loader.load_cloud(str(other)).shape == (0, 3)
    assert "unsupported cloud format" in capsys.readouterr().err
    ply = tmp_path / "cloud.ply"
    ply.write_text("ply\n")
    assert loader.load_cloud(str(ply)).shape == (0, 3)  # malformed: empty, quietly
    assert "unsupported" not in capsys.readouterr().err


def test_resolve_path_matches_original(same_search_roots):
    for path in ("pyproject.toml", "tpuslam/__init__.py", "no/such/file.obj"):
        assert loader.resolve_path(path) == jax_loader.resolve_path(path)


# -- synthesis copy -----------------------------------------------------------


def _rngs(seed=123):
    return (np.random.Generator(np.random.PCG64(seed)),
            np.random.Generator(np.random.PCG64(seed)))


def test_synthesis_helpers_bit_identical():
    a, b = _rngs()
    np.testing.assert_array_equal(
        synthesis.get_random_rotation_matrix(a, 0.2),
        jax_synthesis.get_random_rotation_matrix(b, 0.2),
    )
    np.testing.assert_array_equal(
        synthesis.get_random_translation_vector(a, 10.0),
        jax_synthesis.get_random_translation_vector(b, 10.0),
    )
    np.testing.assert_array_equal(
        synthesis.get_random_permutation(a, 1000),
        jax_synthesis.get_random_permutation(b, 1000),
    )
    cloud = make_cloud(a, 500).astype(np.float64)
    make_cloud(b, 500)
    np.testing.assert_array_equal(
        synthesis.normalize_cloud(cloud, 10.0),
        jax_synthesis.normalize_cloud(cloud, 10.0),
    )
    r = synthesis.get_random_rotation_matrix(a, 0.5)
    jax_synthesis.get_random_rotation_matrix(b, 0.5)
    c32 = cloud.astype(np.float32)
    np.testing.assert_array_equal(
        synthesis.transform_cloud(c32, r, [1, 2, 3], 1.5),
        jax_synthesis.transform_cloud(c32, r, [1, 2, 3], 1.5),
    )
    np.testing.assert_array_equal(
        synthesis.add_noise(a, c32, 0.3, 0.1),
        jax_synthesis.add_noise(b, c32, 0.3, 0.1),
    )
    np.testing.assert_array_equal(
        synthesis.add_outliers(a, c32, 17), jax_synthesis.add_outliers(b, c32, 17)
    )


@pytest.mark.parametrize("variant", ["params", "fixed", "empty"])
def test_get_clouds_from_config_bit_identical(same_search_roots, variant):
    kw = dict(
        before_path="synthetic://3000", after_path="synthetic://3000",
        cloud_before_resize=2000, cloud_after_resize=1500, cloud_spread=10.0,
        random_seed=42, noise_affected_points_before=0.2,
        noise_affected_points_after=0.1, additional_outliers_after=25,
        transformation_parameters=(0.3, 2.0),
    )
    if variant == "fixed":
        kw.update(transformation=(np.eye(3) * 0.5, np.array([1.0, 2.0, 3.0])),
                  after_path="synthetic://2500")
    elif variant == "empty":
        kw.update(before_path="no/such/cloud.obj")
    ours = synthesis.get_clouds_from_config(configuration.Configuration(**kw))
    ref = jax_synthesis.get_clouds_from_config(
        jax_configuration.Configuration(**kw)
    )
    for o, r in zip((ours[0], ours[1], *ours[2]), (ref[0], ref[1], *ref[2])):
        np.testing.assert_array_equal(o, r)


# -- interop ------------------------------------------------------------------


def test_interop_from_jax_state(rng):
    pts = make_cloud(rng, 200)
    jax_cloud = jax_types.pad_cloud(pts)
    cloud = from_numpy_state(to_numpy_state(jax_cloud), "cpu")
    assert isinstance(cloud, types.Cloud)
    np.testing.assert_array_equal(cloud.points.numpy(), np.asarray(jax_cloud.points))
    assert cloud.count.dtype == torch.int32 and int(cloud.count) == 200

    jax_rt = jax_types.RigidTransform(
        jnp.eye(3) * 2, jnp.arange(3.0), jnp.float32(0.5)
    )
    rt = from_numpy_state(to_numpy_state(jax_rt), "cpu")
    assert isinstance(rt, types.RigidTransform)
    for o, r in zip(rt, jax_rt):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert o.dtype == torch.float32


def test_interop_round_trip_of_port_state():
    from tpuslam_torch.algorithms.icp import ICPResume

    resume = ICPResume(
        rotation=torch.eye(3), translation=torch.ones(3),
        error=torch.tensor(0.25), done_before=7, prev_error=torch.tensor(0.5),
    )
    back = from_numpy_state(to_numpy_state(resume), "cpu")
    assert isinstance(back, ICPResume)
    assert back.done_before == 7
    for name in ("rotation", "translation", "error", "prev_error"):
        assert torch.equal(getattr(back, name), getattr(resume, name))
    bare = from_numpy_state(
        to_numpy_state(resume._replace(prev_error=None)), "cpu"
    )
    assert bare.prev_error is None
    with pytest.raises(ValueError, match="unrecognised"):
        from_numpy_state({"foo": np.zeros(3)}, "cpu")
    with pytest.raises(TypeError):
        to_numpy_state(object())
