"""The port's front end below the CLI — config parser, loaders, native
reader and writer, test-set generators, noise suite, runner, timer, run
log and WebGL export — against the JAX package's twins on the same
files, bytes and seeds.

The copies are numpy-only, so most comparisons are exact: parsed
fields, echoes and messages equal; clouds bit for bit; written files
byte for byte; generated configurations field for field.  Registrations
through the runner and the noise suite agree within the whole-run
tolerances of ``test_torch_port.py`` (R and t within 1e-4, equal
iterations); a noise config's ground-truth MSE within 1e-3 relative,
with the same tier and verdict.  JAX tests that read ``data/`` are
mirrored on ``synthetic://`` clouds.
"""

import contextlib
import dataclasses
import enum
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from tests.test_writer import tricky_points
from tpuslam.config import parser as jax_parser
from tpuslam.config.configuration import ComputationMethod as JaxMethod
from tpuslam.data import loader as jax_loader
from tpuslam.data import writer as jax_writer
from tpuslam.harness import logging as jax_logging
from tpuslam.harness import noise as jax_noise
from tpuslam.harness import runner as jax_runner
from tpuslam.harness import testsets as jax_testsets
from tpuslam.native import bindings as jax_bindings
from tpuslam.viz import webgl as jax_webgl
from tpuslam_torch.config import parser
from tpuslam_torch.config.configuration import ComputationMethod, Configuration
from tpuslam_torch.data import loader, writer
from tpuslam_torch.harness import logging as run_logging
from tpuslam_torch.harness import noise, runner, testsets, timer
from tpuslam_torch.native import bindings
from tpuslam_torch.viz import view, webgl

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def same_search_roots(monkeypatch):
    """Both loaders look in the same places, so they see the same files."""
    monkeypatch.setattr(loader, "SEARCH_ROOTS", list(jax_loader.SEARCH_ROOTS))


def values(config) -> dict:
    """A configuration's fields as plain values: enums by value, arrays
    as nested lists (numbers compared exactly)."""
    def norm(v):
        if isinstance(v, enum.Enum):
            return v.value
        if isinstance(v, np.ndarray):
            return [str(v.dtype), v.tolist()]
        if isinstance(v, (tuple, list)):
            return [norm(x) for x in v]
        return v

    return {f.name: norm(getattr(config, f.name)) for f in dataclasses.fields(config)}


# -- config parser -------------------------------------------------------------

BASE = {
    "method": "icp",
    "before-path": "synthetic://512",
    "after-path": "synthetic://512",
    "translation": [1.0, 2.0, 3.0],
    "rotation": [1, 0, 0, 0, 1, 0, 0, 0, 1],
}
CPD_RANGES = {"method": "cpd", "before-path": "a", "after-path": "b",
              "rotation-range": 0.4, "translation-range": 20.0}

PARSER_CASES = {
    "defaults": BASE,
    "row-major rotation, scale": {**BASE, "rotation": [1, 2, 3, 4, 5, 6, 7, 8, 9], "scale": 2.0},
    "rotation-range": CPD_RANGES,
    "angle-range is not read": {**{k: v for k, v in CPD_RANGES.items() if k != "rotation-range"},
                                "angle-range": 0.4},
    "missing transformation": {"method": "icp", "before-path": "a", "after-path": "b"},
    "missing paths": {"method": "icp", "rotation-range": 0.1, "translation-range": 1.0},
    "unknown method": {**BASE, "method": "supericp"},
    "unknown approximation is hybrid": {**BASE, "approximation-type": "bogus"},
    "unknown policy": {**BASE, "policy": "warp"},
    "sequential policy": {**BASE, "policy": "sequential"},
    "wrong rotation size": {**BASE, "rotation": [1, 0, 0]},
    "bad rotation values": {**BASE, "rotation": ["a"] * 9},
    "bad ranges": {**CPD_RANGES, "rotation-range": "wide"},
    "cpd-use-fgt absent": {**CPD_RANGES},
    "cpd-use-fgt false": {**CPD_RANGES, "cpd-use-fgt": False},
    "cpd-use-fgt true": {**CPD_RANGES, "cpd-use-fgt": True},
    "extension keys": {**BASE, "cpd-centroid-init": True, "icp-prealign": True,
                       "save-output-path": "out.obj", "nicp-degenerate-widening": 4},
    "every knob": {**BASE, "max-iterations": 7, "cloud-before-resize": 100,
                   "cloud-after-resize": 90, "cloud-spread": 2.5, "random-seed": 3,
                   "noise-affected-points-before": 0.2, "noise-affected-points-after": 0.1,
                   "show-visualisation": True, "max-distance-squared": 12,
                   "approximation-type": "none", "nicp-batch-size": 4,
                   "nicp-iterations": 9, "nicp-subcloud-size": 77, "cpd-weight": 0.5,
                   "cpd-const-scale": True, "cpd-tolerance": 1e-5,
                   "convergence-epsilon": 1e-6, "noise-intensity-before": 0.3,
                   "noise-intensity-after": 0.4, "additional-outliers-before": 5,
                   "additional-outliers-after": 6, "fgt-ratio-of-far-field": 7.5,
                   "fgt-order-of-truncation": 6},
}


def _parse_both(make_ours, make_ref, capsys):
    ours = make_ours()
    out_ours = capsys.readouterr().out
    ref = make_ref()
    out_ref = capsys.readouterr().out
    assert ours.is_correct() == ref.is_correct()
    assert out_ours == out_ref
    assert values(ours.get_configuration()) == values(ref.get_configuration())
    assert ours.get_configuration().print() == ref.get_configuration().print()
    capsys.readouterr()
    return ours


@pytest.mark.parametrize("case", list(PARSER_CASES))
def test_parser_matches_jax(tmp_path, capsys, case):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(PARSER_CASES[case]))
    ours = _parse_both(lambda: parser.ConfigParser([str(path)]),
                       lambda: jax_parser.ConfigParser([str(path)]), capsys)
    _parse_both(lambda: parser.ConfigParser.from_dict(PARSER_CASES[case]),
                lambda: jax_parser.ConfigParser.from_dict(PARSER_CASES[case]), capsys)
    want_ok = case not in ("angle-range is not read", "missing transformation", "missing paths",
                           "unknown method", "unknown policy", "wrong rotation size",
                           "bad rotation values", "bad ranges")
    assert ours.is_correct() == want_ok


@pytest.mark.parametrize("argv", [[], ["no/such/config.json"], ["a.json", "b.json"],
                                  ["malformed"]])
def test_parser_cli_contract_matches_jax(tmp_path, monkeypatch, capsys, argv):
    monkeypatch.chdir(REPO_ROOT)
    if argv == ["malformed"]:
        bad = tmp_path / "bad.json"
        bad.write_text("{ not json")
        argv = [str(bad)]
    ours = parser.ConfigParser(argv)
    out_ours = capsys.readouterr().out
    ref = jax_parser.ConfigParser(argv)
    out_ref = capsys.readouterr().out
    assert out_ours.replace("tpuslam_torch (", "tpuslam (") == out_ref
    assert ours.is_correct() == ref.is_correct()
    assert values(ours.get_configuration()) == values(ref.get_configuration())
    if len(argv) != 1 or argv[0] == "no/such/config.json":
        assert ours.get_configuration().before_path == "data/bunny.obj"  # the default


def test_cpd_use_fgt_reaches_the_registration(tmp_path):
    # test_config.py::test_cpd_use_fgt_extension_key on a synthetic cloud
    from tpuslam.algorithms.registry import run_with_configuration as jax_run
    from tpuslam.data.synthesis import get_clouds_from_config as jax_clouds
    from tpuslam_torch.algorithms.registry import run_with_configuration
    from tpuslam_torch.data.synthesis import get_clouds_from_config

    cfg = {"method": "cpd", "before-path": "synthetic://400", "after-path": "synthetic://400",
           "cloud-before-resize": 256, "cloud-after-resize": 256, "cloud-spread": 10.0,
           "random-seed": 5, "max-iterations": 40, "approximation-type": "hybrid",
           "cpd-weight": 0.1, "cpd-use-fgt": True, "rotation-range": 0.15,
           "translation-range": 0.5}
    path = tmp_path / "fgt.json"
    path.write_text(json.dumps(cfg))
    with contextlib.redirect_stdout(io.StringIO()):
        config = parser.ConfigParser([str(path)]).get_configuration()
        jconfig = jax_parser.ConfigParser([str(path)]).get_configuration()
    assert config.cpd_use_fgt is True
    before, after, _ = get_clouds_from_config(config)
    jbefore, jafter, _ = jax_clouds(jconfig)
    np.testing.assert_array_equal(before, jbefore)
    rot, trans, iters, err = run_with_configuration(before, after, config, device="cpu")
    jrot, jtrans, jiters, jerr = jax_run(jbefore, jafter, jconfig)
    assert iters == int(jiters) > 0
    np.testing.assert_allclose(rot, np.asarray(jrot), rtol=0, atol=1e-4)
    np.testing.assert_allclose(trans, np.asarray(jtrans), rtol=0, atol=1e-4)


# -- loaders -------------------------------------------------------------------

VERTS = [(0.0, 1.0, 2.0), (3.5, -4.25, 5.125), (-6.0, 7.75, -8.5)]
TRI = [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)]
TRI2 = [(0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.0)]
PLY_XYZ = "property float x\nproperty float y\nproperty float z\n"


def _binary_stl(facets, header=b"\0" * 80):
    body = b"".join(
        struct.pack("<3f", 0.0, 0.0, 1.0) + b"".join(struct.pack("<3f", *v) for v in tri)
        + struct.pack("<H", 0) for tri in facets)
    return header[:80].ljust(80, b"\0") + struct.pack("<I", len(facets)) + body


def _dae(*geoms):
    from tests.test_stl_dae_loader import DAE_TMPL, make_geom

    return DAE_TMPL.format(geoms="".join(make_geom(f"g{i}", g) for i, g in enumerate(geoms)))


# every case of test_ply_loader.py and test_stl_dae_loader.py: (file name, bytes)
LOADER_CASES = {
    "ply ascii": ("tri.ply", (
        "ply\nformat ascii 1.0\ncomment made by hand\nelement vertex 3\n" + PLY_XYZ
        + "property uchar red\nelement face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n" + "".join(f"{x} {y} {z} 128\n" for x, y, z in VERTS) + "3 0 1 2\n")),
    "ply binary little endian": ("tri.ply", (
        "ply\nformat binary_little_endian 1.0\nelement vertex 3\n" + PLY_XYZ
        + "property uchar red\nend_header\n").encode()
        + b"".join(struct.pack("<fffB", x, y, z, 7) for x, y, z in VERTS)),
    "ply binary big endian double": ("tri.ply", (
        "ply\nformat binary_big_endian 1.0\nelement vertex 3\nproperty double x\n"
        "property double y\nproperty double z\nend_header\n").encode()
        + b"".join(struct.pack(">ddd", *v) for v in VERTS)),
    "ply permuted columns": ("perm.ply", (
        "ply\nformat ascii 1.0\nelement vertex 1\nproperty float z\n"
        "property float confidence\nproperty float x\nproperty float y\nend_header\n"
        "2.0 0.9 0.5 1.0\n")),
    "ply ascii truncated": ("short.ply", (
        "ply\nformat ascii 1.0\nelement vertex 5\n" + PLY_XYZ + "end_header\n0 0 0\n1 1 1\n")),
    "ply binary truncated": ("short.ply", (
        "ply\nformat binary_little_endian 1.0\nelement vertex 5\n" + PLY_XYZ
        + "end_header\n").encode() + struct.pack("<fff", 1, 2, 3)),
    "ply no magic": ("nomagic.ply", "plyx\nformat ascii 1.0\nend_header\n"),
    "ply no end_header": ("noend.ply", "ply\nformat ascii 1.0\nelement vertex 1\n"),
    "ply bad format": ("badfmt.ply", "ply\nformat binary_vax 1.0\nelement vertex 1\n"
                       + PLY_XYZ + "end_header\n"),
    "ply no xyz": ("noxyz.ply", "ply\nformat ascii 1.0\nelement vertex 1\nproperty float nx\n"
                   "property float ny\nproperty float nz\nend_header\n0 0 0\n"),
    "ply garbage": ("garbage.ply", "not a ply at all"),
    "ply ascii list in vertex": ("listvert.ply", (
        "ply\nformat ascii 1.0\nelement vertex 1\nproperty list uchar int neighbors\n"
        + PLY_XYZ + "end_header\n2 7 9 1.0 2.0 3.0\n")),
    "ply binary list before vertex": ("listfirst.ply", (
        "ply\nformat binary_little_endian 1.0\nelement face 1\n"
        "property list uchar int vertex_indices\nelement vertex 1\n" + PLY_XYZ
        + "end_header\n").encode() + struct.pack("<Biii", 3, 0, 0, 0)
        + struct.pack("<fff", 1, 2, 3)),
    "ply binary fixed-stride element first": ("skipfirst.ply", (
        "ply\nformat binary_little_endian 1.0\nelement camera 1\nproperty float cx\n"
        "property float cy\nelement vertex 1\n" + PLY_XYZ + "end_header\n").encode()
        + struct.pack("<ff", 9, 9) + struct.pack("<fff", 1, 2, 3)),
    "stl ascii": ("tri.stl", (
        "solid tri\n facet normal 0 0 1\n  outer loop\n   vertex 0 0 0\n   vertex 1 0 0\n"
        "   vertex 0 1 0\n  endloop\n endfacet\n facet normal 0 0 1\n  outer loop\n"
        "   vertex 0 1 0\n   vertex 1 0 0\n   vertex 1 1 0\n  endloop\n endfacet\n"
        "endsolid tri\n")),
    "stl binary": ("tri.stl", _binary_stl([TRI, TRI2])),
    "stl binary with solid header": ("tricky.stl", _binary_stl([TRI], b"solid exported-by-cad")),
    "stl truncated binary": ("bad.stl", b"\0" * 84),
    "dae positions untransformed": ("tri.dae", None),
    "dae two geometries in order": ("two.dae", None),
    "dae malformed": ("broken.dae", "<COLLADA><unclosed>"),
    "dae without geometry": ("empty.dae", '<COLLADA xmlns="http://www.collada.org/2005/11/'
                             'COLLADASchema"></COLLADA>'),
    "unsupported .3ds": ("cloud.3ds", b"\0" * 10),
    "supported .obj stays quiet": ("ok.obj", "v 0 0 0\n"),
    "off": ("pts.off", "OFF\n# comment\n3 0 0\n1 2 3\n\n4 5 6 # tail\n7 8 9.5\n"),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_matches_jax(tmp_path, capsys, case):
    name, data = LOADER_CASES[case]
    if case == "dae positions untransformed":
        data = _dae(TRI)
    elif case == "dae two geometries in order":
        data = _dae(TRI, TRI2)
    path = tmp_path / name
    if isinstance(data, bytes):
        path.write_bytes(data)
    else:
        path.write_text(data)
    ours = loader.load_cloud(str(path))
    err_ours = capsys.readouterr().err
    ref = jax_loader.load_cloud(str(path))
    err_ref = capsys.readouterr().err
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    assert err_ours.replace("[tpuslam_torch]", "[tpuslam]") == err_ref
    if case == "unsupported .3ds":
        assert "unsupported cloud format" in err_ours and ".3ds" in err_ours
    if case.startswith("dae") and case != "dae malformed":
        assert len(ours) or "parsed to zero points" in err_ours


# -- the native reader ---------------------------------------------------------

def _readers(path):
    """Every reader of ``path``'s format: the port's native one first."""
    def guarded(fn):
        try:
            return fn(str(path))
        except Exception:  # noqa: BLE001 — the loaders' contract: empty
            return np.zeros((0, 3), np.float32)

    obj = str(path).endswith(".obj")
    out = {
        "port native": bindings.load_obj(str(path)) if obj else bindings.load_off(str(path)),
        "port python": guarded(loader._load_obj_python if obj else loader._load_off),
        "jax python": guarded(jax_loader._load_obj_python if obj else jax_loader._load_off),
    }
    if jax_bindings.available():
        out["jax native"] = (jax_bindings.load_obj if obj else jax_bindings.load_off)(str(path))
    return out


def _assert_readers_agree(path):
    got = _readers(path)
    want = got["jax python"]
    for name, cloud in got.items():
        assert cloud.shape == want.shape, (name, cloud.shape, want.shape)
        np.testing.assert_array_equal(cloud, want, err_msg=name)
    return want


def test_native_library_builds_outside_the_package():
    assert bindings.available()  # c++ is on this machine
    assert bindings.build().parent == bindings.BUILD_DIR
    assert not list(bindings.SOURCE.parent.glob("*.so"))


NATIVE_CASES = {
    "negative indices and quads": ("t.obj", "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                                   "f 1 2 3 4\nf -1 -2 -3\n"),
    "face-free obj": ("pts.obj", "v 1 2 3\nv 4 5 6\n"),
    "absurd off count": ("bad.off", "OFF 99999999999 0 0\n1 2 3\n"),
    "face over 64 corners": ("big.obj", "".join(f"v {i} {i} {i}\n" for i in range(100))
                             + "f " + " ".join(str(i + 1) for i in range(100)) + "\n"),
}


@pytest.fixture
def port_loads(monkeypatch):
    """The JAX native-loader tests, their ``_loads(path)`` replaced by one
    that holds every reader (the port's native one, both Python ones and
    the JAX native one) to the JAX Python reader and returns the port's
    native result beside it."""
    import tests.test_native_loader as jax_native_tests

    def loads(path):
        want = _assert_readers_agree(path)
        return bindings.load_obj(str(path)) if str(path).endswith(".obj") else \
            bindings.load_off(str(path)), want

    monkeypatch.setattr(jax_native_tests, "_loads", loads)
    return jax_native_tests


def _native_malformed_cases() -> list:
    from tests.test_native_loader import test_malformed_file_parity as jax_case

    (mark,) = [m for m in jax_case.pytestmark if m.name == "parametrize"]
    return mark.args[1]


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_native_reader_matches_jax(tmp_path, case):
    name, text = NATIVE_CASES[case]
    path = tmp_path / name
    path.write_text(text)
    _assert_readers_agree(path)


@pytest.mark.parametrize("name,text", _native_malformed_cases())
def test_native_reader_malformed_matches_jax(port_loads, tmp_path, name, text):
    port_loads.test_malformed_file_parity(tmp_path, name, text)


def test_native_reader_token_grammar_matches_jax(port_loads, tmp_path):
    port_loads.test_float_token_grammar_fuzz_parity(tmp_path)
    port_loads.test_int_token_grammar_fuzz_parity(tmp_path)


@pytest.mark.parametrize("sep", ["\n", "\r", "\r\n"])
def test_native_reader_newlines_match_jax(port_loads, tmp_path, sep):
    port_loads.test_newline_convention_parity(tmp_path, sep)


def test_native_reader_missing_file():
    assert bindings.load_obj("/nonexistent.obj").shape == (0, 3)
    assert bindings.load_off("/nonexistent.off").shape == (0, 3)


def test_native_library_rebuilds_when_the_source_changes(tmp_path, monkeypatch):
    src = tmp_path / "loader.cpp"
    src.write_bytes(bindings.SOURCE.read_bytes())
    monkeypatch.setattr(bindings, "SOURCE", src)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "build")
    first = bindings._digest()
    lib = bindings.build()
    assert lib is not None and lib.exists()
    stamp = lib.with_name(lib.name + ".sha256")
    assert stamp.read_text().strip() == first
    src.write_text(src.read_text() + "\n// changed\n")
    assert bindings._digest() != first
    assert bindings.build() == lib
    assert stamp.read_text().strip() == bindings._digest()
    monkeypatch.setattr(bindings.shutil, "which", lambda name: None)
    src.write_text(src.read_text() + "\n// again\n")
    assert bindings.build() is None  # no compiler: the Python readers serve


# -- writer --------------------------------------------------------------------

@pytest.mark.parametrize("ext", [".obj", ".off"])
def test_writers_byte_identical_to_jax(tmp_path, rng, ext):
    pts = tricky_points(rng, n=513)
    paths = {name: str(tmp_path / f"{name}{ext}") for name in
             ("port", "port_python", "port_native", "jax", "jax_python")}
    assert writer.save_cloud(paths["port"], pts)
    assert jax_writer.save_cloud(paths["jax"], pts)
    (writer._save_obj_python if ext == ".obj" else writer._save_off_python)(
        paths["port_python"], pts)
    (jax_writer._save_obj_python if ext == ".obj" else jax_writer._save_off_python)(
        paths["jax_python"], pts)
    assert (bindings.write_obj if ext == ".obj" else bindings.write_off)(
        paths["port_native"], pts)
    want = open(paths["jax_python"], "rb").read()
    for name, path in paths.items():
        assert open(path, "rb").read() == want, name
    back = loader.load_cloud(paths["port"])
    np.testing.assert_array_equal(back, pts)  # bitwise round trip


def test_writer_contract_matches_jax(tmp_path, rng):
    pts = rng.random((8, 3)).astype(np.float32)
    for save in (writer.save_cloud, jax_writer.save_cloud):
        assert not save(str(tmp_path / "x.ply"), pts)
        assert not save(str(tmp_path / "nodir" / "x.obj"), pts)
        with pytest.raises(ValueError):
            save(str(tmp_path / "bad.obj"), np.zeros((4, 2)))
    empty = str(tmp_path / "empty.off")
    assert writer.save_cloud(empty, np.zeros((0, 3), np.float32))
    assert loader.load_cloud(empty).shape == (0, 3)


def test_webgl_export_byte_identical_to_jax(tmp_path, rng, capsys):
    before = (rng.random((500, 3)) * 10).astype(np.float32)
    clouds = (before, (rng.random((400, 3)) * 10).astype(np.float32), before + 0.1,
              np.zeros((1, 3), np.float32))
    ours = webgl.export_html(*clouds, path=str(tmp_path / "ours.html"))
    ref = jax_webgl.export_html(*clouds, path=str(tmp_path / "ref.html"))
    assert open(ours, "rb").read() == open(ref, "rb").read()
    one = webgl.export_html(before=before, path=str(tmp_path / "one.html"))
    assert '"name": "before"' in open(one).read() and '"after"' not in open(one).read()
    assert "Interactive visualization saved to" in capsys.readouterr().out


def test_view_without_matplotlib_says_so(tmp_path, monkeypatch, capsys, rng):
    import sys

    cloud = rng.random((50, 3)).astype(np.float32)
    path = view.show_registration(cloud, cloud + 1.0, save_path=str(tmp_path / "reg.png"),
                                  show=False)
    assert path and os.path.exists(path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert view.show_registration(cloud, cloud + 1.0, show=False) is None
    assert "matplotlib is not installed" in capsys.readouterr().err


# -- test sets and the noise suite ----------------------------------------------

@pytest.mark.parametrize("name", ["sizes", "performance", "convergence", "noise"])
@pytest.mark.parametrize("method", list(ComputationMethod))
def test_test_sets_match_jax(same_search_roots, name, method):
    ours = testsets.TEST_SETS[name](method)
    ref = jax_testsets.TEST_SETS[name](JaxMethod(method.value))
    assert [values(c) for c in ours] == [values(c) for c in ref]
    assert len(ours) == {"sizes": {"icp": 25, "nicp": 50, "cpd": 10},
                         "performance": {"icp": 52, "nicp": 30, "cpd": 10},
                         "convergence": {"icp": 225, "nicp": 225, "cpd": 225},
                         "noise": {"icp": 0, "nicp": 0, "cpd": 39}}[name][method.value]


@pytest.mark.parametrize("size", [1, 14904, 14905, 35008, 35009, 1375028])
def test_model_ladder_matches_jax(same_search_roots, size):
    assert testsets.get_object_with_min_size(size) == jax_testsets.get_object_with_min_size(size)
    with pytest.raises(ValueError):
        testsets.get_object_with_min_size(1375029)


def test_noise_table_is_a_byte_copy():
    with open(noise.TABLE, "rb") as ours, open(jax_noise.TABLE, "rb") as ref:
        assert ours.read() == ref.read()
    assert len(noise.load_entries()) == 39


@pytest.mark.parametrize("entry", noise.load_entries(), ids=lambda e: f"config{e['id']}")
def test_noise_configurations_match_jax(same_search_roots, entry):
    for cap in (None, 2000):
        ours = noise.build_configuration(entry, size_cap=cap)
        ref = jax_noise.build_configuration(entry, size_cap=cap)
        assert values(ours) == values(ref)
        assert noise.tier_of(entry, ours) == jax_noise.tier_of(entry, ref)
    assert noise.recover_bar(entry) == jax_noise.recover_bar(entry)
    assert noise.angle_deg(entry) == jax_noise.angle_deg(entry)


def test_noise_suite_matches_jax(same_search_roots, tmp_path):
    ours = noise.run_noise_test_set([ComputationMethod.Cpd], output_dir=str(tmp_path / "ours"),
                                    size_cap=2000, only_ids=[4, 5], device="cpu")
    ref = jax_noise.run_noise_test_set([JaxMethod.Cpd], output_dir=str(tmp_path / "ref"),
                                       size_cap=2000, only_ids=[4, 5])
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref]
    rows = [[json.loads(ln) for ln in open(p)] for p in (ours[1], ref[1])]
    assert [r["id"] for r in rows[0]] == [r["id"] for r in rows[1]] == [4, 5]
    for got, want in zip(*rows):
        for key in ("tier", "ok", "bar", "self", "n_before", "iterations", "angle_deg",
                    "reference_note"):
            assert got[key] == want[key], key
        assert got["gt_mse"] == pytest.approx(want["gt_mse"], rel=1e-3)
        assert got["identity_mse"] == pytest.approx(want["identity_mse"], rel=1e-6)


def test_noise_suite_cap_from_the_environment(monkeypatch, tmp_path, capsys):
    calls = []
    monkeypatch.setattr(noise, "build_configuration",
                        lambda e, size_cap=None: calls.append(size_cap) or Configuration())
    monkeypatch.setattr("tpuslam_torch.harness.runner.run_test_set",
                        lambda acquire, *a, **k: acquire(None) and [])
    monkeypatch.setenv("TPUSLAM_NOISE_CAP", "123")
    noise.run_noise_test_set([ComputationMethod.Cpd], output_dir=str(tmp_path), only_ids=[4],
                             device="cpu")
    monkeypatch.setenv("TPUSLAM_NOISE_CAP", "lots")
    noise.run_noise_test_set([ComputationMethod.Cpd], output_dir=str(tmp_path), only_ids=[4],
                             device="cpu")
    assert calls == [123, None]
    assert "ignoring malformed TPUSLAM_NOISE_CAP" in capsys.readouterr().out
    assert noise.run_noise_test_set([ComputationMethod.Icp], output_dir=str(tmp_path),
                                    device="cpu") == []


# -- runner, timer, run log ------------------------------------------------------

def _tiny(package_config, method, sizes=(200, 300), **kw):
    """Configurations registering a whole synthetic cloud with a moved copy
    of itself.  (Subsamples drawn apart leave ICP on a plateau, where the
    divergence guard stops it when the error rises by a rounding, so two
    implementations may stop iterations apart with equal results.)"""
    fields = dict(cloud_spread=10.0, max_iterations=10, max_distance_squared=10000.0,
                  transformation_parameters=(0.2, 5.0), random_seed=1, cpd_weight=0.1)
    return [package_config(computation_method=method, before_path=f"synthetic://{n}",
                           after_path=f"synthetic://{n}", cloud_before_resize=n,
                           cloud_after_resize=n, **{**fields, **kw}) for n in sizes]


def _stub(before, after, config):
    r = np.eye(3, dtype=np.float32) * np.float32(len(before) / 1000)
    return r, after.mean(axis=0), len(after) % 7, float(np.abs(before).sum())


def _csv_without_time(path):
    rows = [ln.rstrip("\n").split(";") for ln in open(path)]
    return [r[:4] + r[5:] for r in rows]


def test_runner_csv_matches_jax_under_a_stub(tmp_path, capsys):
    from tpuslam.config.configuration import Configuration as JaxConfiguration

    ours = runner.run_test_set(
        lambda m: _tiny(Configuration, m), "mini",
        [ComputationMethod.Icp, ComputationMethod.Cpd], compute_function=_stub,
        output_dir=str(tmp_path / "ours"), device="cpu")
    out_ours = capsys.readouterr().out
    ref = jax_runner.run_test_set(
        lambda m: _tiny(JaxConfiguration, m), "mini", [JaxMethod.Icp, JaxMethod.Cpd],
        compute_function=_stub, output_dir=str(tmp_path / "ref"))
    out_ref = capsys.readouterr().out
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref]
    for a, b in zip(ours, ref):
        assert _csv_without_time(a) == _csv_without_time(b)
        assert open(a).readline() == runner.CSV_HEADER
    strip = [ln for ln in out_ours.splitlines() if not ln.startswith("  test:")]
    assert strip == [ln for ln in out_ref.splitlines() if not ln.startswith("  test:")]


def test_runner_real_compute_matches_jax(tmp_path):
    from tpuslam.config.configuration import Configuration as JaxConfiguration

    kw = dict(sizes=(256,), max_iterations=25, random_seed=666)
    ours = runner.TestRunner(output_file=str(tmp_path / "ours.csv"), device="cpu")
    ours.add_test(_tiny(Configuration, ComputationMethod.Icp, **kw)[0])
    ref = jax_runner.TestRunner(output_file=str(tmp_path / "ref.csv"))
    ref.add_test(_tiny(JaxConfiguration, JaxMethod.Icp, **kw)[0])
    for r in (ours, ref):
        r.run_all()
        r.close()
    got, want = (_csv_without_time(tmp_path / f) for f in ("ours.csv", "ref.csv"))
    assert got[0] == want[0] and got[1][:5] == want[1][:5]  # through iterations
    assert float(got[1][5]) == pytest.approx(float(want[1][5]), abs=1e-4)


def test_runner_resume_skips_completed(tmp_path):
    seen = []

    def fake(before, after, config):
        seen.append(len(before))
        return np.eye(3), np.zeros(3), 1, 0.0

    out = tmp_path / "mini-icp.csv"
    out.write_text(runner.CSV_HEADER + "0;200;0.200000;5.000000;7;1;0.000000\n")
    runner.run_test_set(lambda m: _tiny(Configuration, m), "mini", [ComputationMethod.Icp],
                        compute_function=fake, output_dir=str(tmp_path), resume=True,
                        device="cpu")
    assert seen == [300]
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 3 and lines[1].startswith("0;200;") and lines[2].startswith("1;300;")


def test_runner_warmup_runs_the_same_inputs_twice(tmp_path):
    calls = []

    def fake(before, after, config):
        calls.append((before.copy(), after.copy()))
        return np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1, 0.0

    r = runner.TestRunner(fake, output_file=str(tmp_path / "w.csv"), warmup=True, device="cpu")
    r.add_test(_tiny(Configuration, ComputationMethod.Icp, sizes=(100,))[0])
    r.run_all()
    r.close()
    assert len(calls) == 2
    for warm, timed in zip(*calls):
        np.testing.assert_array_equal(warm, timed)  # unperturbed


def test_runner_jsonl_record_matches_jax_keys(tmp_path):
    out = tmp_path / "runs.jsonl"
    r = runner.TestRunner(_stub, jsonl_path=str(out), device="cpu")
    r.add_test(_tiny(Configuration, ComputationMethod.Icp, sizes=(200,))[0])
    r.run_all()
    rec = json.loads(out.read_text().strip())
    from tpuslam.config.configuration import Configuration as JaxConfiguration

    ref = jax_logging.result_record(JaxConfiguration(), np.eye(3), np.zeros(3), 1, 0.0)
    assert list(rec) == list(ref)
    assert rec["backend"] == "cpu" and rec["cloud_sizes"] == [200, 200]
    assert "test" in rec["timings_ms"]
    meta = run_logging.result_record(Configuration(), np.eye(3), np.zeros(3), 1, 0.0,
                                     device=torch.device("meta"))
    assert meta["backend"] == "meta"


def test_timer_matches_jax_and_fences(tmp_path):
    from tpuslam.harness.timer import Timer as JaxTimer

    t, j = timer.Timer("t"), JaxTimer("t")
    for clock in (t, j):
        clock.start_stage("a")
        clock.stop_stage("a")
        clock.stop_stage("never started")
    assert t.print_results().splitlines()[0] == j.print_results().splitlines()[0]
    out = t.stage_timed_call("x", lambda: (torch.ones(4), [np.ones(2)], {"k": torch.zeros(1)}))
    assert float(out[0][0]) == 1.0 and t.get_stage_time("x") >= 0
    assert list(timer._tensors(out)) == [out[0], out[2]["k"]]
    with t.profiled(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof.key_averages()
    assert list((tmp_path / "trace").iterdir())
