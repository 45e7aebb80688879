"""The JAX package's verdicts on the 39-config noise suite at full size on
the CPU: the table the port's card run is held to, the script that makes
it, and the tests that hold the committed table to the suite.

    python3 tests/test_torch_noise_reference.py [--workers 3] [--ids 1,2,...]
                                                [--package jax|port] [--out PATH]

Each config of ``tpuslam/harness/data/noise_suite.jsonl`` is built at its
real size (``tpuslam.harness.noise.build_configuration``), registered by
``tpuslam.algorithms.registry.run_with_configuration`` on the JAX CPU
backend and graded (``noise.grade``).  The rows go to
``tpuslam_torch/harness/data/noise_suite_reference.jsonl`` with the
fixture the ``synthetic://`` clouds were built from (``tiled-bunny`` where
``data/bunny.obj`` resolves, else ``uniform-box``): a model missing from
the checkout is replaced by a synthetic cloud, so the verdicts hold for
that fixture only.  ``chip_smoke.py`` (phase 19) requires the port on the
card to pass every config the table passes.  The registrations take
about an hour on the CPU, so the tests here do not rerun them: they
check that the table has a row for every config, with the size, tier and
bar the suite gives it on the table's fixture.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import pytest

from tpuslam_torch.data.loader import synthetic_fixture

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)  # spawned workers import this file by its path
OUT = os.path.join(REPO_ROOT, "tpuslam_torch", "harness", "data",
                   "noise_suite_reference.jsonl")


def run_one(config_id: int, package: str = "jax") -> dict:
    """Register and grade one config on the CPU with the JAX package or,
    with ``package="port"``, with ``tpuslam_torch``."""
    import numpy as np

    if package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from tpuslam.algorithms.registry import run_with_configuration
        from tpuslam.data.synthesis import get_clouds_from_config
        from tpuslam.harness import noise

        run, backend = run_with_configuration, jax.default_backend()
    else:
        from tpuslam_torch.algorithms.registry import run_with_configuration
        from tpuslam_torch.data.synthesis import get_clouds_from_config
        from tpuslam_torch.harness import noise

        def run(before, after, config):
            return run_with_configuration(before, after, config, device="cpu")

        backend = "cpu"
    entry = next(e for e in noise.load_entries() if e["id"] == config_id)
    config = noise.build_configuration(entry)
    before, after, _ = get_clouds_from_config(config)
    t0 = time.perf_counter()
    rot, trans, iters, err = run(before, after, config)
    row = noise.grade(entry, config, np.asarray(before), np.asarray(rot), np.asarray(trans))
    return {
        "id": config_id, "fixture": synthetic_fixture(), "before": config.before_path,
        "n_before": row["n_before"], "tier": row["tier"], "bar": row["bar"], "ok": row["ok"],
        "gt_mse": row["gt_mse"], "identity_mse": row["identity_mse"],
        "iterations": int(iters), "error": float(err),
        "seconds_cpu": time.perf_counter() - t0, "backend": backend,
    }


def read_table(path: str = OUT) -> list:
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip() and not ln.startswith("#")]


def test_table_has_every_config_with_its_tier():
    from tpuslam.data.synthesis import get_clouds_from_config
    from tpuslam.harness import noise

    rows = read_table()
    entries = noise.load_entries()
    assert [r["id"] for r in rows] == [e["id"] for e in entries]
    for entry, row in zip(entries, rows):
        assert row["backend"] == "cpu"
        if row["fixture"] != synthetic_fixture():
            continue
        config = noise.build_configuration(entry)
        assert row["before"] == config.before_path
        assert (row["tier"], row["bar"]) == noise.tier_of(entry, config)
        if entry["id"] in (1, 13, 38):  # synthesis at full size: one per tier and shape
            before, _, _ = get_clouds_from_config(config)
            assert row["n_before"] == len(before)
        assert row["ok"] == (row["gt_mse"] <= row["identity_mse"] * row["bar"])


@pytest.mark.parametrize("config_id", [4, 13, 38])
def test_grade_of_the_port_matches_jax(config_id):
    """The port's ``grade`` (which phase 19 applies on the card) gives the
    JAX package's tier row for the same result."""
    import numpy as np

    from tpuslam.harness import noise as jax_noise
    from tpuslam_torch.harness import noise

    entry = next(e for e in noise.load_entries() if e["id"] == config_id)
    rng = np.random.Generator(np.random.PCG64(config_id))
    before = (rng.random((500, 3)) * 10).astype(np.float32)
    rot = np.asarray(entry["rotation"], np.float32).reshape(3, 3)
    trans = rng.random(3).astype(np.float32)
    ours = noise.grade(entry, noise.build_configuration(entry), before, rot, trans)
    ref = jax_noise.grade(entry, jax_noise.build_configuration(entry), before, rot, trans)
    assert ours == ref


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--ids", default=",".join(str(i) for i in range(1, 40)))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--package", choices=("jax", "port"), default="jax",
                    help="port: the same configs through tpuslam_torch on the CPU (to "
                         "compare; the committed table is the JAX package's)")
    args = ap.parse_args()
    ids = [int(i) for i in args.ids.split(",")]
    with ProcessPoolExecutor(args.workers, mp_context=get_context("spawn")) as pool:
        rows = list(pool.map(run_one, ids, [args.package] * len(ids)))
    who = "JAX package's" if args.package == "jax" else "port's"
    with open(args.out, "w") as fh:
        fh.write(f"# the {who} noise-suite verdicts at full size on the CPU; "
                 "made by tests/test_torch_noise_reference.py\n")
        for row in sorted(rows, key=lambda r: r["id"]):
            fh.write(json.dumps(row) + "\n")
    print(f"{sum(r['ok'] for r in rows)}/{len(rows)} ok -> {args.out}")


if __name__ == "__main__":
    main()
